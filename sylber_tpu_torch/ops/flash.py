"""Blocked online-softmax attention for long sequences.

Port of ``sylber_tpu/ops/pallas/flash.py::flash_attention``. On a CUDA
tensor :func:`flash_attention` launches the kernel of ``csrc/flash.cu`` (its
header says what bounds it and how the design answers that); on a CPU tensor
it runs :func:`flash_attention_plain`.

Numerics are those of the TPU kernel: everything in fp32 (q scaled in fp32,
``scale`` may be overridden), masked keys weigh exactly 0, and a query row
with no valid key (``kv_len == 0``) gives 0. Key padding is a per-item
``kv_len``; the ragged edge is masked inside the kernel, nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import check, lib, require_cuda, stream_of

MAX_HEAD_DIM = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Reference: fp32 softmax attention with zero rows where nothing is valid."""
    B, H, L, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    keep = torch.arange(L, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    keep = keep[:, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p / denom, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention, any L, D <= 64, keys ``>= kv_len[b]`` masked.

    ``q, k, v``: float32 or bfloat16, one dtype; ``kv_len``: (B,) int32.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, scale)
    B, H, L, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_attention: q/k/v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v shapes differ")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError("flash_attention: kv_len must be (B,) int32")
    require_cuda("flash_attention", q, k, v, kv_len)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    check(lib().sylber_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, H, L, D, float(scale),
        int(q.dtype == torch.bfloat16), stream_of(q)), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
