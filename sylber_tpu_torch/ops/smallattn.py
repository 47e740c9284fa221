"""Attention for short sequences (L <= 512) with per-item key padding.

Port of ``sylber_tpu/ops/pallas/smallattn.py::fused_attention_small``. On a
CUDA tensor :func:`small_attention` launches the kernel of
``csrc/smallattn.cu`` (its header says what bounds it and how the design
answers that); on a CPU tensor it runs :func:`small_attention_plain`.

Numerics are those of the JAX XLA path: q scaled in the input dtype before
QK^T, fp32 scores and softmax, keys at or past ``kv_len`` set to -1e30 (an
item with ``kv_len == 0`` gets the uniform mean of V), probabilities cast to
the input dtype before PV.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import check, lib, require_cuda, stream_of

MAX_SEQ = 512
MAX_HEAD_DIM = 128
_NEG = -1e30


def _dtype_scale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The softmax scale as the JAX code holds it: a scalar of the input dtype."""
    return torch.tensor(scale, dtype=dtype)


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention over (B, H, L, D); any L."""
    B, H, L, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qs = q * _dtype_scale(scale, q.dtype).to(q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    keep = torch.arange(L, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention, L <= 512, keys ``>= kv_len[b]`` masked.

    ``q, k, v``: float32 or bfloat16, one dtype; ``kv_len``: (B,) int32.
    """
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, kv_len, scale)
    B, H, L, D = q.shape
    if L > MAX_SEQ or D > MAX_HEAD_DIM:
        raise ValueError(f"small_attention: L={L} > {MAX_SEQ} or "
                         f"D={D} > {MAX_HEAD_DIM}; use flash_attention")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"small_attention: q/k/v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("small_attention: q, k, v shapes differ")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError("small_attention: kv_len must be (B,) int32")
    require_cuda("small_attention", q, k, v, kv_len)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    check(lib().sylber_small_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, H, L, D, float(_dtype_scale(scale, q.dtype)),
        int(q.dtype == torch.bfloat16), stream_of(q)), "small_attention")
    small_attention.launches += 1
    return out


small_attention.launches = 0
