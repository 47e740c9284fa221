"""HuBERT encoder in PyTorch.

Port of ``sylber_tpu/models/hubert.py`` (itself HF ``modeling_hubert`` with
``do_stable_layer_norm=False``):

- waveform frontend: 7 strided Conv1d layers, no bias. Layer 0 (k=10, s=5,
  GroupNorm with one group per channel, exact GELU) runs through the fused
  kernel of ``ops/frontend.py``; layers 1-6 are ``F.conv1d`` + GELU in
  ``frontend_dtype``;
- feature projection: LayerNorm (fp32) -> Linear;
- padded frames zeroed, then the grouped positional conv (k=128, 16 groups,
  trailing frame dropped for the even kernel) + GELU, added;
- encoder LayerNorm, then post-LN transformer layers.

Two serving forms of the encoder layers, as in JAX: ``fused_qkv`` (one
(3d, d) product for q/k/v) and ``int8_encoder`` (dynamic W8A8 for the
attention projections and the feed-forward pair, ``ops/int8.py``, on the
int8 kernels of ``csrc/int8_gemm.cu``; the parameters stay float32 and are
quantized once per load, ``ops/int8.py::QuantizedWeights``, where JAX
quantizes them in every forward). ``int8_encoder`` is an inference mode: the
rounding has no gradient, so the model refuses it in train mode or where
autograd records.

Key padding reaches attention as per-item frame counts (``kv_len``). Linear
layers and convs compute in the configured dtype from fp32 parameters, as
flax ``Dense(dtype=...)`` does; LayerNorm statistics are fp32.

The hand-written kernels (layer 0, attention) have no backward pass, as
their TPU counterparts have none. So the model runs them only when autograd
records nothing and the model is in eval mode (the Segmenter, the trainer's
teacher). Otherwise (the trainer's student) layer 0 and the attention core
are the differentiable torch ops that mirror the JAX package's XLA training
path (:func:`conv0_layer_xla`, ``ops/attention.py::attention_xla``). In
train mode the dropouts sit where the JAX model puts them, their masks drawn
from generators seeded per call (see :meth:`HubertModel.forward`), and
``remat`` recomputes each encoder layer in the backward pass
(``torch.utils.checkpoint``) with the same masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops.attention import Dropout, MultiHeadSelfAttention, linear
from ..ops.frontend import KERNEL_SIZE, STRIDE, analytic_moments_plain, conv0_gn_gelu
from ..ops.int8 import QuantizedWeights, int8_linear

DType = Union[torch.dtype, str]


def as_dtype(dtype: DType) -> torch.dtype:
    """``torch.bfloat16`` from itself or from ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """Architecture hyper-parameters (hubert-base-ls960 defaults, 9 layers).

    The fields are those of ``sylber_tpu.models.hubert.HubertConfig``.
    Dropout rates apply in train mode. ``frontend_l0_analytic`` selects the
    form of the differentiable layer 0 (None: analytic moments exactly where
    ``frontend_dtype`` is not float32, as in JAX); the fused kernel of the
    inference path always takes its moments from the waveform (summed in
    fp64) and keeps the erf GELU.
    """

    hidden_size: int = 768
    num_hidden_layers: int = 9
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_proj_layer_norm: bool = True
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    # compute dtype of the projection, positional conv and encoder layers
    dtype: DType = torch.float32
    # "highest": fp32 convs and matmuls without TF32 (parity mode);
    # "default": TF32 allowed (see matmul_precision)
    precision: str = "highest"
    # compute dtype of frontend convs 1-6 (and of layer 0's output)
    frontend_dtype: DType = torch.float32
    remat: bool = False
    fused_qkv: bool = False
    int8_encoder: bool = False
    frontend_l0_analytic: Optional[bool] = None
    # tanh GELU; None = tanh exactly where the op's dtype is not float32
    gelu_tanh: Optional[bool] = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "frontend_dtype", as_dtype(self.frontend_dtype))
        if self.conv_bias or (self.conv_kernel[0], self.conv_stride[0]) != (
                KERNEL_SIZE, STRIDE):
            raise NotImplementedError(
                "frontend layer 0 runs the fused kernel, which takes "
                f"conv_kernel[0]={KERNEL_SIZE}, conv_stride[0]={STRIDE}, no bias")

    def gelu_approx_for(self, dtype: DType) -> bool:
        """tanh-vs-erf GELU choice for an op running at ``dtype``."""
        if self.gelu_tanh is None:
            return as_dtype(dtype) != torch.float32
        return self.gelu_tanh

    @property
    def gelu_approximate(self) -> bool:
        return self.gelu_approx_for(self.dtype)

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.conv_stride:
            s *= st
        return s

    def feat_extract_output_length(self, input_length):
        """Conv output length, chained floor((L - k) / s) + 1 (HF formula)."""
        length = input_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Hold the CUDA TF32 flags for fp32 matmuls and convs for a block.

    ``"highest"`` turns TF32 off for both (cuDNN convolutions default to it),
    the counterpart of JAX ``precision="highest"``; ``"default"`` turns it on,
    the counterpart of the TPU's reduced-precision passes. The flags are
    process-wide and are restored on exit; one thread at a time holds them
    (a server's dispatcher runs the encoder while its request threads run
    the quantizer's distance matmul).
    """
    tf32 = precision != "highest"
    with _TF32_FLAGS:
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


_TF32_FLAGS = threading.RLock()


def feature_vector_attention_mask(config: HubertConfig,
                                  attention_mask: torch.Tensor,
                                  num_frames: int) -> torch.Tensor:
    """Downsample a sample-level mask (B, L) to frame level (B, T) int32."""
    out_lengths = config.feat_extract_output_length(attention_mask.sum(-1))
    frame_idx = torch.arange(num_frames, device=attention_mask.device)[None, :]
    return (frame_idx < out_lengths[:, None]).to(torch.int32)


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """fp32 statistics, output in ``dtype`` (flax ``LayerNorm(dtype=...)``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _analytic_l0_stats(x: torch.Tensor, w: torch.Tensor, eps: float):
    """GroupNorm mean and inverse std of ``conv1d(x, w, stride=5)`` from the
    input (JAX ``_analytic_l0_stats``), by the fused kernel's own formula
    ``ops/frontend.py::analytic_moments_plain`` in fp64, returned in fp32.
    The gradient reaches ``w`` through it."""
    mean, var = analytic_moments_plain(x, w)
    return mean.float(), torch.rsqrt(var.float() + eps)


def conv0_layer_xla(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, cfg: HubertConfig) -> torch.Tensor:
    """Frontend layer 0, differentiable, as the JAX package's XLA training
    path computes it (``sylber_tpu/models/hubert.py::ConvFeatureEncoder``):

    - float32 (``frontend_l0_analytic`` off): the conv in fp32, flax's
      GroupNorm (``E[y^2] - E[y]^2`` moments over time, clipped at 0;
      ``(y - mean) * (rsqrt(var + eps) * gamma) + beta``), then exact GELU;
    - analytic (the default where ``frontend_dtype`` is bf16): moments from
      the input in fp32, the conv in ``frontend_dtype``, the affine folded
      into a per-channel scale and offset in that dtype, tanh GELU there.

    ``x`` (B, L) float32, ``w`` (D, 1, 10). Returns (B, D, T0) in
    ``frontend_dtype``. This is not the fused kernel's plain version: that
    one is ``ops/frontend.py::conv0_gn_gelu_plain``."""
    eps, dt = cfg.layer_norm_eps, cfg.frontend_dtype
    analytic = cfg.frontend_l0_analytic
    if analytic is None:
        analytic = dt != torch.float32
    if analytic and x.shape[1] >= KERNEL_SIZE + STRIDE:
        mean, inv = _analytic_l0_stats(x, w, eps)
        y = F.conv1d(x[:, None].to(dt), w.to(dt), stride=STRIDE)
        scale = (inv * gamma).to(dt)[..., None]
        off = (beta - mean * inv * gamma).to(dt)[..., None]
        return _gelu(y * scale + off, dt != torch.float32)
    y = F.conv1d(x[:, None].float(), w, stride=STRIDE)
    mean = y.mean(-1, keepdim=True)
    var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (y - mean) * (torch.rsqrt(var + eps) * gamma[:, None]) + beta[:, None]
    return _gelu(y, False).to(dt)


class ConvFeatureEncoder(nn.Module):
    """Waveform frontend: 7 strided Conv1d layers, GroupNorm on layer 0."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        dims_in = (1,) + tuple(cfg.conv_dim[:-1])
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, k, s, bias=False)
            for i, o, k, s in zip(dims_in, cfg.conv_dim, cfg.conv_kernel,
                                  cfg.conv_stride))
        self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0],
                                       eps=cfg.layer_norm_eps)

    def forward(self, wav: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
        """(B, L) float32 -> (B, T, conv_dim[-1]) float32; layer 0 through
        the fused kernel unless ``differentiable``."""
        cfg, dt = self.cfg, self.cfg.frontend_dtype
        args = (self.convs[0].weight, self.group_norm.weight, self.group_norm.bias)
        if differentiable:
            x = conv0_layer_xla(wav.float(), *args, cfg)
        else:
            x = conv0_gn_gelu(wav.float().contiguous(), *args,
                              eps=cfg.layer_norm_eps, out_dtype=dt)
        approx = cfg.gelu_approx_for(dt)
        for conv in self.convs[1:]:
            x = _gelu(F.conv1d(x, conv.weight.to(dt), stride=conv.stride), approx)
        return x.transpose(1, 2).float()


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = (nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
                           if cfg.feat_proj_layer_norm else None)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm is not None:
            x = _layer_norm(x, self.layer_norm, torch.float32)
        return linear(x, self.projection, self.cfg.dtype)


# Frames (batch x length) from which the bf16 positional conv on CUDA runs as
# an fp32 conv on rounded tensors also without autograd (PositionalConvEmbedding).
# On an H100 with torch 2.11 cuDNN's bf16 kernel is about as fast or faster up to
# 24,000 frames and 6-7x slower from 24,784 on (scripts/torch_posconv_probe.py).
POS_CONV_FP32_FRAMES = 24_576


class PositionalConvEmbedding(nn.Module):
    """Grouped Conv1d positional embedding (weight norm folded at load)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, C) in ``cfg.dtype``.

        In bf16 the conv takes one of two forms with the same rounding of
        inputs, weight and bias: cuDNN's bf16 grouped conv, or an fp32 conv
        on the bf16-rounded tensors (bf16 values are exact in TF32, so under
        ``"default"`` precision this is the bf16 conv with fp32 sums). cuDNN's
        form runs only on CUDA without autograd and below
        ``POS_CONV_FP32_FRAMES`` frames (batch x length): past them, and in
        its backward above all, it is far slower
        (``scripts/torch_posconv_probe.py``; ``PERF.md``, section 6). On the
        CPU the fp32 form always runs: oneDNN's bf16 grouped conv gives wrong
        sums in torch 2.13's CPU build."""
        dt, conv = self.cfg.dtype, self.conv
        records = torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad)
        if (dt != torch.float32 and x.is_cuda and not records
                and x.shape[0] * x.shape[1] < POS_CONV_FP32_FRAMES):
            out = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                           padding=conv.padding, groups=conv.groups)
        else:
            rounded = lambda t: t.to(dt).float()  # noqa: E731
            out = F.conv1d(rounded(x.transpose(1, 2)), rounded(conv.weight),
                           rounded(conv.bias), padding=conv.padding,
                           groups=conv.groups).to(dt)
        if conv.kernel_size[0] % 2 == 0:
            out = out[:, :, :-1]  # HF SamePadLayer: drop the trailing frame
        return _gelu(out, self.cfg.gelu_approximate).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (HF ``HubertEncoderLayer``)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.attention = MultiHeadSelfAttention(d, cfg.num_attention_heads, cfg.fused_qkv,
                                                cfg.int8_encoder)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate_dense = nn.Linear(d, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self._int8_weights = QuantizedWeights()

    def forward(self, x: torch.Tensor, kv_len: torch.Tensor, seed: Optional[int] = None,
                differentiable: bool = False) -> torch.Tensor:
        """``seed`` set: train mode, the dropout masks drawn from a generator
        seeded with it (so a recomputation draws them again);
        ``differentiable``: the attention core in torch ops, not the kernel."""
        cfg, dt = self.cfg, self.cfg.dtype
        drop = Dropout(seed, x.device) if seed is not None else Dropout.OFF
        attn = self.attention(x, kv_len, dt, differentiable=differentiable,
                              dropout=drop, dropout_rate=cfg.attention_dropout)
        x = x + drop(attn, cfg.hidden_dropout)
        x = _layer_norm(x, self.layer_norm, dt)
        h = _gelu(self._dense(x, "intermediate_dense"), cfg.gelu_approximate)
        h = drop(h, cfg.activation_dropout)
        x = x + drop(self._dense(h, "output_dense"), cfg.hidden_dropout)
        return _layer_norm(x, self.final_layer_norm, dt)

    def _dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        layer = getattr(self, name)
        if self.cfg.int8_encoder:
            wq, sw = self._int8_weights(name, [layer.weight])
            return int8_linear(x, wq, sw, layer.bias, self.cfg.dtype)
        return linear(x, layer, self.cfg.dtype)


class HubertModel(nn.Module):
    """Full HuBERT encoder: waveform (B, L) in, frame features (B, T, hidden) out."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.encoder_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Returns the last hidden state (B, T, hidden) in ``cfg.dtype``.

        In train mode the dropout masks come from device generators seeded
        with one seed per encoder layer and one for the rest, drawn from
        ``generator`` (a CPU generator, so drawing reads nothing from the
        device; the default CPU generator when None)."""
        with matmul_precision(self.cfg.precision):
            return self._forward(input_values, attention_mask, mask_time_indices,
                                 generator)

    def _forward(self, input_values, attention_mask, mask_time_indices, generator):
        cfg = self.cfg
        differentiable = self.training or torch.is_grad_enabled()
        if cfg.int8_encoder and differentiable:
            raise RuntimeError("int8_encoder is an inference/serving mode (its rounding has "
                               "no gradient): run it under torch.no_grad() or "
                               "torch.inference_mode() in eval mode, and train in bf16")
        seeds = [None] * (cfg.num_hidden_layers + 1)
        if self.training:
            seeds = torch.randint(0, 2 ** 62, (len(seeds),), generator=generator).tolist()
        drop = Dropout(seeds[0], input_values.device) if self.training else Dropout.OFF
        feats = self.feature_extractor(input_values, differentiable)
        B, T, _ = feats.shape
        x = drop(self.feature_projection(feats.to(cfg.dtype)), cfg.feat_proj_dropout)
        if mask_time_indices is not None:
            x = torch.where(mask_time_indices[..., None],
                            self.masked_spec_embed.to(x.dtype), x)
        if attention_mask is not None:
            frame_mask = feature_vector_attention_mask(cfg, attention_mask, T)
            x = x * frame_mask[..., None].to(x.dtype)  # HF zeroes padded frames
            kv_len = frame_mask.sum(-1).to(torch.int32)
        else:
            kv_len = torch.full((B,), T, dtype=torch.int32, device=x.device)
        x = x + self.pos_conv_embed(x)
        x = drop(_layer_norm(x, self.encoder_layer_norm, cfg.dtype), cfg.hidden_dropout)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer, seed in zip(self.layers, seeds[1:]):
            if remat:
                x = checkpoint(layer, x, kv_len, seed, differentiable,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, kv_len, seed, differentiable)
        return x


@torch.no_grad()
def init_weights(model: HubertModel, generator: torch.Generator) -> HubertModel:
    """Seeded random weights (tests and benchmarks): normal(0, 1/sqrt(fan_in))
    for convs, normal(0, 0.02) for linear layers, unit/zero norms, zero biases."""
    for module in model.modules():
        if isinstance(module, nn.Conv1d):
            fan_in = module.weight.shape[1] * module.weight.shape[2]
            module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Linear):
            module.weight.normal_(0.0, 0.02, generator=generator)
            module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
    return model
