"""Blocked online-softmax attention for long sequences.

Port of ``sylber_tpu/ops/pallas/flash.py::flash_attention``. On a CUDA
tensor :func:`flash_attention` launches the kernel of ``csrc/flash.cu`` (its
header says what bounds it and how the design answers that); on a CPU tensor
it runs :func:`flash_attention_plain`.

Numerics are those of the TPU kernel: softmax state and accumulator in fp32,
q scaled by ``scale`` (which may be overridden), masked keys weigh exactly
0, and a query row with no valid key (``kv_len == 0``) gives 0. Key padding
is a per-item ``kv_len``; the ragged edge is masked inside the kernel,
nothing is padded. On fp32 inputs everything is fp32. On bf16 inputs the
kernel runs on the tensor cores: it scales the fp32 scores, so q is not
rounded, and rounds P to bf16 for the P V product where the TPU kernel kept
fp32; the plain version stays the fp32 reference and the two agree to 2e-2.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._attn_launch import launch_attention

MAX_HEAD_DIM = 128
MAX_SEQ = 2 ** 31 - 1  # any length an int holds


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
    """(B, H, L, D) attention, any L, D <= 128, keys ``>= kv_len[b]`` masked.

    ``q, k, v``: float32 or bfloat16, one dtype, any (batch, head, row)
    strides (a ``(B, L, H, D)`` projection viewed as ``(B, H, L, D)`` is not
    copied; the output then has that layout too); ``kv_len``: (B,) int32.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, scale)
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    out = launch_attention("sylber_flash_attention", "flash_attention", q, k, v,
                           kv_len, float(scale), MAX_SEQ, MAX_HEAD_DIM)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
