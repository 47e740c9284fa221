"""Attention for short sequences (L <= 512) with per-item key padding.

Port of ``sylber_tpu/ops/pallas/smallattn.py::fused_attention_small``. On a
CUDA tensor :func:`small_attention` launches the kernel of
``csrc/smallattn.cu`` (its header says what bounds it and how the design
answers that); on a CPU tensor it runs :func:`small_attention_plain`.

Numerics are those of the JAX XLA path: q scaled in the input dtype before
QK^T, fp32 scores and softmax, keys at or past ``kv_len`` set to -1e30 (an
item with ``kv_len == 0`` gets the uniform mean of V), probabilities cast to
the input dtype before PV. The kernel tiles the keys and keeps an online
softmax, so it rounds P before the division by the row sum: fp32 agrees to
2e-5, bf16 (tensor cores) to 2e-2.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._attn_launch import launch_attention

MAX_SEQ = 512
MAX_HEAD_DIM = 128
_NEG = -1e30


def _dtype_scale(scale: float, dtype: torch.dtype) -> float:
    """The softmax scale as the JAX code holds it: rounded to the input dtype."""
    return float(torch.tensor(scale, dtype=dtype))


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention over (B, H, L, D); any L."""
    B, H, L, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qs = q * _dtype_scale(scale, q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    keep = torch.arange(L, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention, L <= 512, keys ``>= kv_len[b]`` masked.

    ``q, k, v``: float32 or bfloat16, one dtype, any (batch, head, row)
    strides (a ``(B, L, H, D)`` projection viewed as ``(B, H, L, D)`` is not
    copied; the output then has that layout too); ``kv_len``: (B,) int32.
    """
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, kv_len, scale)
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    out = launch_attention(
        "sylber_small_attention", "small_attention", q, k, v, kv_len,
        _dtype_scale(scale, q.dtype), MAX_SEQ, MAX_HEAD_DIM)
    small_attention.launches += 1
    return out


small_attention.launches = 0
