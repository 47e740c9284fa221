"""Voicebox-style flow-matching vector-field network in PyTorch.

Port of ``sylber_tpu/models/voicebox.py``: RoPE attention with per-head QK
RMSNorm and a fixed softmax scale of 10, AdaptiveRMSNorm conditioned on the
flow-time embedding, GEGLU feed-forward, register tokens at RoPE position
-10000, optional U-Net skip connections, a depthwise conv (kernel 31)
positional embedding. Resynthesis width: depth 8, dim 512, 8 heads of 64,
``dim_in_proj`` 64, ``dim_cond_emb`` 256.

Module and parameter names mirror the JAX tree (``transformer.attn_0.to_qkv``
is ``transformer/attn_0/to_qkv``), so ``io/checkpoint.py`` carries weights
between the two packages by renaming leaves only.

The attention core is ``ops/attention.py::attention``: the small-attention
kernel up to L 512 (registers included), flash above, the plain version on
the CPU. The scale of 10 goes to the kernel as its scale; q is never
pre-scaled. The kernels are forward-only: in train mode or under autograd
the core is ``ops/attention.py::attention_xla`` at the same scale (JAX's
XLA path), as the HuBERT student's is. In train mode the masks of
``ff_dropout`` (after the GEGLU) come from the ``Dropout`` the caller
passes, drawn in call order. ``attn_dropout`` is declared and, as in JAX's
regressor, never applied; both are 0 in every shipped config.

Key padding is a per-item key count: without a mask every key is valid
(``kv_len`` = L, as at inference, where JAX passes no mask); a mask must be
a prefix, which is asserted on the device without a read back.

The RoPE inverse frequencies are built on the host: ``theta ** (i / d)`` in
float64 rounded to float32 (XLA's float32 power is correctly rounded;
torch's float32 power differs by an ulp at some ``i``, which the angles of
the registers at -10000 would magnify), then ``1 / x`` in float32. The
angles are ``positions * inv`` in float32 on the device, as JAX computes
them.

With ``use_gateloop_layers`` a ``SimpleGateLoop`` block (RMSNorm, a
bias-free ``to_qkva`` product, a sigmoid gate, the GateLoop recurrence of
``ops/gateloop.py``, a LayerNorm of epsilon 1e-6) is added as a residual
before each attention block: on the card the recurrence is the kernel of
``csrc/gateloop.cu``, under autograd JAX's associative scan in torch ops.

``dtype`` (JAX's field; float32 or bfloat16): every ``Dense`` of JAX's
that takes it computes in it from float32 parameters (``proj_in``,
``to_embed``, the depthwise conv, ``to_qkv``, ``to_out``, the GEGLU pair,
``skip_combiner_*``, ``to_qkva``, ``to_pred``); the norms, the time
embedding and its MLP, the adaptive norms' products and the rotary angles
stay float32, and JAX's type promotion is kept: an RMS norm's float32 gamma
and the float32 rotary angles make q and k float32, so the attention core
runs in float32 on a bf16-rounded v, as JAX's ``dot_product_attention``
promotes it (on the card the float32 kernels; a bf16 core would round the
qk-normed q and k, whose products the scale of 10 magnifies); the
GateLoop recurrence runs in float32 between casts (``ops/gateloop.py``).
In bf16 the depthwise conv is an fp32 conv of the bf16-rounded input,
weight and bias, rounded to bf16 (a bf16 conv with float32 sums), on both
devices: one form everywhere, and none of oneDNN's bf16 grouped convs, whose
grouped form ``ROADMAP.md`` section 3 records as faulty (its depthwise form
is not: ``tests/test_torch_voicebox_bf16.py``); the conv is a small part of
a call. The regressor's output is in ``dtype``, as JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.hubert import DType, as_dtype
from ..ops.attention import Dropout, attention, attention_xla
from ..ops.gateloop import gate_loop_operator


@dataclasses.dataclass(frozen=True)
class RegressorConfig:
    dim: int = 512
    depth: int = 8
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    dim_out: int = 14            # 12 EMA dims + log-pitch + loudness
    dim_in_proj: int = 64
    dim_cond_emb: int = 256
    conv_pos_embed_kernel_size: int = 31
    num_register_tokens: int = 16
    attn_qk_norm: bool = True
    qk_norm_scale: float = 10.0
    use_unet_skip_connection: bool = False
    use_gateloop_layers: bool = False
    skip_connect_scale: Optional[float] = None
    rope_theta: float = 50000.0
    time_hidden_dim: Optional[int] = None  # default dim * 4
    frac_lengths_mask: tuple = (0.7, 1.0)
    sigma: float = 0.0
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    # "default": TF32 matmuls and convs on the card; "highest": full fp32
    precision: str = "default"
    dtype: DType = torch.float32   # the Dense layers' compute dtype (JAX's field)

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))

    @property
    def time_hidden(self) -> int:
        return self.time_hidden_dim or self.dim * 4


def rope_inverse_frequencies(dim_head: int, theta: float) -> np.ndarray:
    """(dim_head // 2,) float32 ``1 / theta ** (arange(0, d, 2) / d)``, each
    power correctly rounded (see the module docstring)."""
    y = np.arange(0, dim_head, 2, dtype=np.float32) / np.float32(dim_head)
    power = (float(theta) ** y.astype(np.float64)).astype(np.float32)
    return (np.float32(1.0) / power).astype(np.float32)


def rope_frequencies(positions: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(L,) positions -> (L, dim_head) rotary angles (the frequencies twice);
    ``inv`` from :func:`rope_inverse_frequencies`."""
    f = positions.float()[:, None] * inv[None, :]
    return torch.cat([f, f], dim=-1)


def apply_rope(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t: (..., L, dim_head); pos: (L, dim_head) angles."""
    d = t.shape[-1]
    t1, t2 = t[..., : d // 2], t[..., d // 2:]
    rotated = torch.cat([-t2, t1], dim=-1)
    return t * torch.cos(pos) + rotated * torch.sin(pos)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize``: x / max(||x||, eps)."""
    n = torch.sqrt((x.float() ** 2).sum(-1, keepdim=True))
    return (x / n.clamp_min(eps)).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` from its float32 parameters (flax
    ``Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _same_pad(k: int):
    """flax ``padding="SAME"`` at stride 1: (left, right)."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _l2norm(x) * (self.dim ** 0.5) * self.gamma


class AdaptiveRMSNorm(nn.Module):
    """gamma/beta from the time embedding."""

    def __init__(self, dim: int, cond_dim: int):
        super().__init__()
        self.dim = dim
        self.to_gamma = nn.Linear(cond_dim, dim)
        self.to_beta = nn.Linear(cond_dim, dim)

    def forward(self, x, cond):
        normed = _l2norm(x) * (self.dim ** 0.5)
        return normed * self.to_gamma(cond)[:, None, :] + self.to_beta(cond)[:, None, :]


class Attention(nn.Module):
    def __init__(self, cfg: RegressorConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.dim_head * cfg.heads
        self.to_qkv = nn.Linear(cfg.dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, cfg.dim, bias=False)
        if cfg.attn_qk_norm:
            self.q_norm_gamma = nn.Parameter(torch.ones(cfg.heads, 1, cfg.dim_head))
            self.k_norm_gamma = nn.Parameter(torch.ones(cfg.heads, 1, cfg.dim_head))

    def forward(self, x, kv_len, rope, differentiable: bool = False):
        c = self.cfg
        B, L, _ = x.shape
        q, k, v = (t.reshape(B, L, c.heads, c.dim_head).transpose(1, 2)
                   for t in dense(x, self.to_qkv, c.dtype).chunk(3, dim=-1))
        scale = None
        if c.attn_qk_norm:
            q = _l2norm(q) * (c.dim_head ** 0.5) * self.q_norm_gamma
            k = _l2norm(k) * (c.dim_head ** 0.5) * self.k_norm_gamma
            scale = c.qk_norm_scale
        q, k = apply_rope(rope, q), apply_rope(rope, k)
        v = v.to(q.dtype)  # float32 angles make q and k float32 (JAX's promotion)
        if differentiable:
            out = attention_xla(q, k, v, kv_len, scale=scale)
        else:
            out = attention(q, k, v, kv_len, scale)
        return dense(out.transpose(1, 2).reshape(B, L, c.heads * c.dim_head), self.to_out,
                     c.dtype)


class GEGLUFeedForward(nn.Module):
    def __init__(self, cfg: RegressorConfig):
        super().__init__()
        inner = int(cfg.dim * cfg.ff_mult * 2 / 3)
        self.ff_dropout, self.dtype = cfg.ff_dropout, cfg.dtype
        self.proj_in = nn.Linear(cfg.dim, inner * 2)
        self.proj_out = nn.Linear(inner, cfg.dim)

    def forward(self, x, dropout: Dropout = Dropout.OFF):
        # torch chunk order: (x, gate)
        val, gate = dense(x, self.proj_in, self.dtype).chunk(2, dim=-1)
        return dense(dropout(_gelu(gate) * val, self.ff_dropout), self.proj_out, self.dtype)


class SimpleGateLoop(nn.Module):
    """One-headed GateLoop block (JAX ``SimpleGateLoop``): RMSNorm, one
    bias-free product to (q, kv, gate), a sigmoid gate, the per-channel
    recurrence, then a LayerNorm (flax's default epsilon, 1e-6). The caller
    adds the residual. q, kv and the gate are views of the product; the
    kernel reads them in place. Where autograd records, the operator takes
    JAX's associative scan in torch ops (``ops/gateloop.py``)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = RMSNorm(dim)
        self.to_qkva = nn.Linear(dim, 3 * dim, bias=False)
        self.post_ln = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        q, kv, a = dense(self.norm(x), self.to_qkva, self.dtype).chunk(3, dim=-1)
        out = gate_loop_operator(q, kv, torch.sigmoid(a))
        # flax's LayerNorm with float32 parameters: float32 statistics and output
        return F.layer_norm(out.float(), self.post_ln.normalized_shape, self.post_ln.weight,
                            self.post_ln.bias, self.post_ln.eps)


class VoiceboxTransformer(nn.Module):
    """Pre-norm transformer with AdaptiveRMSNorm, register tokens, RoPE."""

    def __init__(self, cfg: RegressorConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.zeros(cfg.num_register_tokens, cfg.dim))
        # a buffer, so that it moves with the module: no copy from the host per call
        self.register_buffer("rope_inv", torch.from_numpy(
            rope_inverse_frequencies(cfg.dim_head, cfg.rope_theta)), persistent=False)
        for ind in range(cfg.depth):
            if self._has_skip(ind):
                self.add_module(f"skip_combiner_{ind}", nn.Linear(2 * cfg.dim, cfg.dim))
            if cfg.use_gateloop_layers:
                self.add_module(f"gateloop_{ind}", SimpleGateLoop(cfg.dim, cfg.dtype))
            self.add_module(f"attn_norm_{ind}", AdaptiveRMSNorm(cfg.dim, cfg.time_hidden))
            self.add_module(f"attn_{ind}", Attention(cfg))
            self.add_module(f"ff_norm_{ind}", AdaptiveRMSNorm(cfg.dim, cfg.time_hidden))
            self.add_module(f"ff_{ind}", GEGLUFeedForward(cfg))
        self.final_norm = RMSNorm(cfg.dim)

    def _has_skip(self, ind: int) -> bool:
        return self.cfg.use_unet_skip_connection and ind + 1 > self.cfg.depth // 2

    def forward(self, x, kv_len, time_cond, dropout: Dropout = Dropout.OFF,
                differentiable: bool = False):
        c = self.cfg
        B, L, _ = x.shape
        n_reg = c.num_register_tokens
        positions = torch.arange(L, dtype=torch.float32, device=x.device)
        if n_reg > 0:
            x = torch.cat([self.register_tokens.to(x.dtype).expand(B, n_reg, c.dim), x], dim=1)
            kv_len = kv_len + n_reg
            positions = torch.cat([torch.full((n_reg,), -10000.0, device=x.device), positions])
        rope = rope_frequencies(positions, self.rope_inv)

        skip_scale = c.skip_connect_scale if c.skip_connect_scale is not None else 2 ** -0.5
        skips = []
        for ind in range(c.depth):
            if not self._has_skip(ind):
                skips.append(x)
            else:
                skip = skips.pop() * skip_scale
                x = dense(torch.cat([x, skip], dim=-1), getattr(self, f"skip_combiner_{ind}"),
                          c.dtype)
            if c.use_gateloop_layers:
                x = getattr(self, f"gateloop_{ind}")(x) + x
            attn_in = getattr(self, f"attn_norm_{ind}")(x, time_cond)
            x = getattr(self, f"attn_{ind}")(attn_in, kv_len, rope, differentiable) + x
            ff_in = getattr(self, f"ff_norm_{ind}")(x, time_cond)
            x = getattr(self, f"ff_{ind}")(ff_in, dropout) + x

        if n_reg > 0:
            x = x[:, n_reg:]
        return self.final_norm(x)


def prefix_lengths(mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32 valid lengths of a (B, L) prefix mask. That the mask is a
    prefix is asserted on its device, with nothing read back (on a GPU a
    mask that is not one fails the next synchronising call)."""
    mask = mask.bool()
    n = mask.sum(-1).to(torch.int32)
    prefix = torch.arange(mask.shape[1], device=mask.device)[None, :] < n[:, None]
    torch._assert_async((prefix == mask).all(),
                        "self_attn_mask must be a prefix mask (valid frames first)")
    return n


class Regressor(nn.Module):
    """Vector field: (x_t, times, cond, cond_emb) -> dx/dt prediction."""

    def __init__(self, cfg: RegressorConfig):
        super().__init__()
        self.cfg = cfg
        self.proj_in = nn.Linear(cfg.dim_out, cfg.dim_in_proj)
        self.time_freqs = nn.Parameter(torch.zeros(cfg.dim // 2))
        self.time_mlp = nn.Linear(cfg.dim, cfg.time_hidden)
        self.to_embed = nn.Linear(2 * cfg.dim_in_proj + cfg.dim_cond_emb, cfg.dim)
        k = cfg.conv_pos_embed_kernel_size
        self.conv_pos_embed = nn.Conv1d(cfg.dim, cfg.dim, k, groups=cfg.dim)
        self.transformer = VoiceboxTransformer(cfg)
        self.to_pred = nn.Linear(cfg.dim, cfg.dim_out, bias=False)

    def time_embedding(self, times: torch.Tensor) -> torch.Tensor:
        """Learned sinusoidal embedding -> Linear -> SiLU, (B, time_hidden)."""
        f = times.float()[:, None] * self.time_freqs[None, :] * 2 * math.pi
        return F.silu(self.time_mlp(torch.cat([torch.sin(f), torch.cos(f)], dim=-1)))

    def forward(self, x, times, cond=None, cond_emb=None, self_attn_mask=None,
                cond_mask=None, dropout: Dropout = Dropout.OFF):
        """``times``: a number, a 0-d tensor or (B,); ``self_attn_mask``
        (B, L) prefix mask or None (every frame valid); ``dropout``: the
        masks' source in train mode (``Dropout.OFF``: none)."""
        B, L, _ = x.shape
        dt = self.cfg.dtype
        x = dense(x, self.proj_in, dt)
        cond = torch.zeros_like(x) if cond is None else dense(cond, self.proj_in, dt)  # shared
        if cond_mask is not None:
            cond = cond * (~cond_mask)[..., None].to(cond.dtype)
        if not torch.is_tensor(times):  # a fill, not a copy from the host
            times = torch.full((B,), float(times), dtype=torch.float32, device=x.device)
        elif times.ndim == 0:
            times = times.expand(B)
        temb = self.time_embedding(times)

        parts = [x] + ([cond_emb.to(x.dtype)] if cond_emb is not None else []) + [cond]
        h = dense(torch.cat(parts, dim=-1), self.to_embed, dt)

        if self_attn_mask is None:
            kv_len = torch.full((B,), L, dtype=torch.int32, device=x.device)
        else:
            kv_len = prefix_lengths(self_attn_mask)
            h = h * self_attn_mask[..., None].to(h.dtype)
        conv = self.conv_pos_embed
        # in bf16: an fp32 conv of the rounded tensors, rounded (the module docstring)
        rounded = lambda t: t.to(dt).float()  # noqa: E731
        pos = F.conv1d(F.pad(rounded(h.transpose(1, 2)), _same_pad(conv.kernel_size[0])),
                       rounded(conv.weight), rounded(conv.bias), groups=self.cfg.dim).to(dt)
        pos = _gelu(pos).transpose(1, 2)
        if self_attn_mask is not None:
            pos = pos * self_attn_mask[..., None].to(pos.dtype)
        h = pos + h

        if not self.training:
            dropout = Dropout.OFF
        differentiable = self.training or torch.is_grad_enabled()
        h = self.transformer(h, kv_len, temb, dropout, differentiable)
        return dense(h, self.to_pred, dt)


@torch.no_grad()
def init_regressor(model: Regressor, generator: torch.Generator) -> Regressor:
    """Seeded random weights: linear and conv weights normal(0, 1/sqrt(fan_in)),
    zero biases; the adaptive norms near identity (weights normal(0, 0.02),
    gamma bias 1); register tokens and time frequencies normal(0, 1); norm
    gammas 1."""
    for name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            w = module.weight
            fan_in = w.shape[1] * (w.shape[2] if w.ndim == 3 else 1)
            std = 0.02 if name.rsplit(".", 1)[-1] in ("to_gamma", "to_beta") else fan_in ** -0.5
            w.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.fill_(1.0 if name.endswith("to_gamma") else 0.0)
    model.time_freqs.normal_(0.0, 1.0, generator=generator)
    if model.cfg.num_register_tokens > 0:
        model.transformer.register_tokens.normal_(0.0, 1.0, generator=generator)
    return model
