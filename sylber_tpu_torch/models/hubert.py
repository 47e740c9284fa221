"""HuBERT encoder in PyTorch, inference only.

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

Key padding reaches attention as per-item frame counts (``kv_len``). Linear
layers and convs compute in the configured dtype from fp32 parameters, as
flax ``Dense(dtype=...)`` does; LayerNorm statistics are fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiHeadSelfAttention, linear
from ..ops.frontend import KERNEL_SIZE, STRIDE, conv0_gn_gelu

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
    Dropout rates are kept for configuration compatibility; this port runs
    inference only. ``frontend_l0_analytic`` selects nothing here: layer 0
    always runs the fused kernel, which takes its GroupNorm moments from the
    waveform (the analytic form, summed in fp64) and keeps the erf GELU.
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
        if self.int8_encoder or self.remat or self.fused_qkv:
            raise NotImplementedError(
                "int8_encoder, remat and fused_qkv are not ported yet")
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
    process-wide and are restored on exit.
    """
    tf32 = precision != "highest"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, L) float32 -> (B, T, conv_dim[-1]) float32."""
        cfg, dt = self.cfg, self.cfg.frontend_dtype
        x = conv0_gn_gelu(wav.float().contiguous(), self.convs[0].weight,
                          self.group_norm.weight, self.group_norm.bias,
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


class PositionalConvEmbedding(nn.Module):
    """Grouped Conv1d positional embedding (weight norm folded at load)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, C) in ``cfg.dtype``."""
        dt = self.cfg.dtype
        out = F.conv1d(x.transpose(1, 2).to(dt), self.conv.weight.to(dt),
                       self.conv.bias.to(dt), padding=self.conv.padding,
                       groups=self.conv.groups)
        if self.conv.kernel_size[0] % 2 == 0:
            out = out[:, :, :-1]  # HF SamePadLayer: drop the trailing frame
        return _gelu(out, self.cfg.gelu_approximate).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (HF ``HubertEncoderLayer``)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.attention = MultiHeadSelfAttention(d, cfg.num_attention_heads)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate_dense = nn.Linear(d, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attention(x, kv_len, dt)
        x = _layer_norm(x, self.layer_norm, dt)
        h = _gelu(linear(x, self.intermediate_dense, dt), self.cfg.gelu_approximate)
        x = x + linear(h, self.output_dense, dt)
        return _layer_norm(x, self.final_layer_norm, dt)


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
                mask_time_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Returns the last hidden state (B, T, hidden) in ``cfg.dtype``."""
        with matmul_precision(self.cfg.precision):
            return self._forward(input_values, attention_mask, mask_time_indices)

    def _forward(self, input_values, attention_mask, mask_time_indices):
        cfg = self.cfg
        feats = self.feature_extractor(input_values)
        B, T, _ = feats.shape
        x = self.feature_projection(feats.to(cfg.dtype))
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
        x = _layer_norm(x, self.encoder_layer_norm, cfg.dtype)
        for layer in self.layers:
            x = layer(x, kv_len)
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
