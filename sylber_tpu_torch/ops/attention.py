"""Self-attention of the HuBERT encoder layers.

Port of ``sylber_tpu/ops/attention.py::MultiHeadSelfAttention``: separate
q/k/v/out projections (plain ``F.linear``, as the JAX package left them to
XLA), and the attention core dispatched on what the inputs show:

- CPU tensors: the plain path, whose numerics are the JAX XLA path's;
- CUDA, L <= 512: the small-attention kernel (``ops/smallattn.py``);
- CUDA, L > 512: the flash kernel (``ops/flash.py``).

Key padding travels as a per-item valid length ``kv_len`` (B,) int32, taken
from the frame lengths, never as a materialised bias. The heads are split as
strided views of the projections, which the kernels read in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .flash import flash_attention
from .smallattn import MAX_SEQ, small_attention, small_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention, any strides, keys ``>= kv_len[b]`` masked."""
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, kv_len, scale)
    if q.shape[-2] <= MAX_SEQ:
        return small_attention(q, k, v, kv_len, scale)
    return flash_attention(q, k, v, kv_len, scale)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MultiHeadSelfAttention(nn.Module):
    """HF ``HubertAttention`` parameterisation, inference only."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, kv_len: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        B, L, d = x.shape
        h = self.num_heads
        q, k, v = (linear(x, p, dtype) for p in (self.q_proj, self.k_proj, self.v_proj))
        # (B, H, L, D) views of the projections: the kernels take strides and
        # write the output in the same layout, so nothing is copied here
        split = lambda t: t.view(B, L, h, d // h).transpose(1, 2)  # noqa: E731
        out = attention(split(q), split(k), split(v), kv_len)
        out = out.transpose(1, 2).reshape(B, L, d)
        return linear(out, self.out_proj, dtype)
