"""Self-attention of the HuBERT encoder layers.

Port of ``sylber_tpu/ops/attention.py::MultiHeadSelfAttention``: separate
q/k/v/out projections (plain ``F.linear``, as the JAX package left them to
XLA), and the attention core dispatched on what the inputs show:

- CPU tensors: the plain path, whose numerics are the JAX XLA path's;
- CUDA, L <= 512: the small-attention kernel (``ops/smallattn.py``);
- CUDA, L > 512: the flash kernel (``ops/flash.py``).

The kernels are forward-only, as the TPU kernels are. Where a gradient is
needed (the trainer's student) the layer takes :func:`attention_xla`
instead: the JAX package's XLA ``dot_product_attention`` in torch ops, with
dropout on the probabilities, which is where JAX goes whenever probability
dropout is on.

Key padding travels as a per-item valid length ``kv_len`` (B,) int32, taken
from the frame lengths, never as a materialised bias. The heads are split as
strided views of the projections, which the kernels read in place.

Two serving forms of the projections, as JAX's layer has them (the
parameter tree stays the four separate ``nn.Linear`` layers):

- ``fused_qkv``: one (3d, d) ``F.linear`` on the concatenated q/k/v weights
  and biases; q, k and v are views of its (B, L, 3d) output;
- ``int8``: dynamic W8A8 (``ops/int8.py``): the three weights quantized row
  by row into one (3d, d) int8 operand (per-output-channel scales make that
  the quantization of the concatenation), one int8 product, and the out
  projection in int8 too; both operands are quantized once per load and
  kept (``QuantizedWeights``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .flash import flash_attention
from .int8 import QuantizedWeights, int8_linear
from .smallattn import MAX_SEQ, small_attention, small_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention, any strides, keys ``>= kv_len[b]`` masked."""
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, kv_len, scale)
    if q.shape[-2] <= MAX_SEQ:
        return small_attention(q, k, v, kv_len, scale)
    return flash_attention(q, k, v, kv_len, scale)


class Dropout:
    """Dropout whose masks come from one device generator seeded with
    ``seed``, drawn in call order as ``rand(shape) < 1 - rate`` and scaled by
    ``1 / (1 - rate)`` (flax ``nn.Dropout``'s formula; ``F.dropout`` takes no
    generator). Seeded anew, it draws the same masks again, which a
    recomputation in the backward pass needs. ``Dropout.OFF`` drops nothing."""

    def __init__(self, seed: Optional[int], device):
        self.generator = None
        if seed is not None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(int(seed))

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


Dropout.OFF = Dropout(None, "cpu")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, dropout: Dropout = Dropout.OFF,
                  dropout_rate: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, L, D) attention in differentiable torch ops, as
    ``sylber_tpu/ops/attention.py::dot_product_attention`` computes it on its
    XLA path: q scaled in its dtype, fp32 scores, a key-padding bias of the
    float32 minimum at keys ``>= kv_len[b]``, fp32 softmax cast to the
    input dtype, dropout on the probabilities, then P V accumulated in fp32
    and cast. Not SDPA, and not a kernel's plain version."""
    B, H, L, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qs = q * float(torch.tensor(scale, dtype=q.dtype))
    scores = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    keep = torch.arange(L, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MultiHeadSelfAttention(nn.Module):
    """HF ``HubertAttention`` parameterisation."""

    def __init__(self, d_model: int, num_heads: int, fused_qkv: bool = False,
                 int8: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.fused_qkv, self.int8 = fused_qkv, int8
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self._int8_weights = QuantizedWeights()

    def _qkv(self, x: torch.Tensor, dtype: torch.dtype):
        """q, k, v (B, L, d) in ``dtype``: three products, or views of one."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        if not (self.int8 or self.fused_qkv):
            return [linear(x, p, dtype) for p in projs]
        bias = torch.cat([p.bias for p in projs])
        if self.int8:
            wq, sw = self._int8_weights("qkv", [p.weight for p in projs])
            qkv = int8_linear(x, wq, sw, bias, dtype)
        else:
            weight = torch.cat([p.weight for p in projs])
            qkv = F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))
        return qkv.chunk(3, dim=-1)

    def forward(self, x: torch.Tensor, kv_len: torch.Tensor, dtype: torch.dtype,
                differentiable: bool = False, dropout: Dropout = Dropout.OFF,
                dropout_rate: float = 0.0) -> torch.Tensor:
        """The kernels' core, or with ``differentiable`` :func:`attention_xla`
        (which alone applies ``dropout`` to the probabilities)."""
        B, L, d = x.shape
        h = self.num_heads
        q, k, v = self._qkv(x, dtype)
        # (B, H, L, D) views of the projections: the kernels take strides and
        # write the output with its heads side by side, so nothing is copied here
        split = lambda t: t.view(B, L, h, d // h).transpose(1, 2)  # noqa: E731
        if differentiable:
            out = attention_xla(split(q), split(k), split(v), kv_len, dropout, dropout_rate)
        else:
            out = attention(split(q), split(k), split(v), kv_len)
        out = out.transpose(1, 2).reshape(B, L, d)
        if self.int8:
            wq, sw = self._int8_weights("out", [self.out_proj.weight])
            return int8_linear(out, wq, sw, self.out_proj.bias, dtype)
        return linear(out, self.out_proj, dtype)
