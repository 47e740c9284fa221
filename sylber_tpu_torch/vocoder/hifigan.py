"""HiFi-GAN generator with the optional NSF harmonic source.

Port of the generator of ``sylber_tpu/vocoder/hifigan.py`` (HiFi-GAN v1,
Kong et al. 2020): input conv -> per stage [leaky ReLU -> transposed conv
(upsample) -> (+ the harmonic source, downsampled by a strided conv) ->
multi-receptive-field fusion of ResBlock1s, averaged] -> leaky ReLU -> conv
-> tanh. Upsample rates (5, 4, 4, 2, 2) = x320 map 50 Hz frames to 16 kHz.

Layouts: activations are channels-first (B, C, T) for cuDNN. flax's
``ConvTranspose`` (VALID, kernel not flipped) followed by the crop of
``(k - u) // 2`` a side is ``conv_transpose1d`` with ``padding=(k - u) // 2``
on the kernel flipped along its spatial axis; the modules hold torch's
layout and ``io/checkpoint.py`` flips on the way in and out. flax ``SAME``
pads ``(k - 1) * d`` in all, the smaller half on the left; on the strided
source convs the total depends on the length (``ceil(L / s)`` outputs), so
the pad is computed per call and applied with ``F.pad``.

The harmonic phase is a cumulative sum over the output samples (320 per
frame). XLA sums it in float32, in an order of its own; here the sum runs
in float64 and is rounded to float32, so the card and the CPU give the
same phase, while JAX's float32 drift separates the two packages as the
input grows (the tests compare waveforms at short lengths and longer ones
through ``log_mel``). The noise channel is drawn from a
``torch.Generator`` seeded with 0 unless ``noise`` is given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    in_channels: int = 14                 # SPARC articulatory features
    cond_channels: int = 0                # speaker embedding (broadcast)
    upsample_initial_channel: int = 512
    upsample_rates: Sequence[int] = (5, 4, 4, 2, 2)      # x320 at 50 Hz
    upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Tuple[int, ...]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    harmonic_source: bool = False
    pitch_channel: int = 12            # absolute log-pitch channel: log(f0 / 100)
    sample_rate: int = 16000
    n_harmonics: int = 8
    source_amp: float = 0.1
    source_noise: float = 0.003

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)


def _conv_same(x: torch.Tensor, conv: nn.Conv1d, stride: int = 1, dilation: int = 1):
    """flax ``Conv(padding="SAME")`` on (B, C, T)."""
    k = conv.kernel_size[0]
    T = x.shape[-1]
    out_len = -(-T // stride)
    total = max((out_len - 1) * stride + (k - 1) * dilation + 1 - T, 0)
    left = total // 2
    if left == total - left:
        return F.conv1d(x, conv.weight, conv.bias, stride, left, dilation)
    return F.conv1d(F.pad(x, (left, total - left)), conv.weight, conv.bias, stride, 0, dilation)


class ResBlock1(nn.Module):
    """Pairs of (dilated, plain) convs with residuals."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...]):
        super().__init__()
        self.dilations = tuple(dilations)
        for j in range(len(self.dilations)):
            self.add_module(f"convs1_{j}", nn.Conv1d(channels, channels, kernel_size))
            self.add_module(f"convs2_{j}", nn.Conv1d(channels, channels, kernel_size))

    def forward(self, x):
        for j, d in enumerate(self.dilations):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = _conv_same(xt, getattr(self, f"convs1_{j}"), dilation=d)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            x = x + _conv_same(xt, getattr(self, f"convs2_{j}"))
        return x


def harmonic_noise_source(features: torch.Tensor, cfg: HiFiGANConfig,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NSF excitation from ``features[..., cfg.pitch_channel]`` (absolute
    log-pitch log(f0 / 100)): (B, T * total_upsample, n_harmonics + 1)
    float32, sine harmonics with phase 2 pi cumsum(h f0 / sr) (zero above
    Nyquist) and one broadband-noise channel (``noise`` (B, T * total), or
    drawn from a generator seeded with 0, as JAX draws from ``PRNGKey(0)``)."""
    f0 = 100.0 * torch.exp(features[..., cfg.pitch_channel].float())      # (B, T) Hz
    f0_up = torch.repeat_interleave(f0, cfg.total_upsample, dim=1)       # (B, L)
    # the running sum in float64, so that every device rounds it alike
    phase = 2.0 * math.pi * torch.cumsum((f0_up / cfg.sample_rate).double(), dim=1).float()
    h = torch.arange(1, cfg.n_harmonics + 1, dtype=torch.float32, device=features.device)
    sines = torch.sin(phase[..., None] * h)
    alive = (f0_up[..., None] * h) < (cfg.sample_rate / 2.0)
    sines = cfg.source_amp * sines * alive
    if noise is None:
        g = torch.Generator(device=features.device).manual_seed(0)
        noise = torch.randn(f0_up.shape, generator=g, device=features.device)
    return torch.cat([sines, (cfg.source_noise * noise)[..., None]], dim=-1)


class Generator(nn.Module):
    def __init__(self, config: HiFiGANConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.upsample_initial_channel < 2 ** len(cfg.upsample_rates):
            raise ValueError("upsample_initial_channel halves per stage and must stay >= 1")
        self.conv_pre = nn.Conv1d(cfg.in_channels + cfg.cond_channels,
                                  cfg.upsample_initial_channel, 7)
        ch, cum = cfg.upsample_initial_channel, 1
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cum *= u
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=u,
                                                           padding=(k - u) // 2))
            ch //= 2
            if cfg.harmonic_source:
                stride = cfg.total_upsample // cum
                self.add_module(f"source_{i}", nn.Conv1d(cfg.n_harmonics + 1, ch,
                                                         2 * stride + 1, stride=stride))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7)

    def forward(self, features: torch.Tensor, cond: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, in_channels) frames [+ (B, cond_channels) global
        conditioning] -> (B, T * total_upsample) waveform in [-1, 1]."""
        cfg = self.config
        src = None
        if cfg.harmonic_source:
            src = harmonic_noise_source(features, cfg, noise).transpose(1, 2)
        x = features.float()
        if cfg.cond_channels:
            if cond is None:
                raise ValueError("this generator needs a (B, cond_channels) conditioning")
            x = torch.cat([x, cond.float()[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)
        x = _conv_same(x.transpose(1, 2), self.conv_pre)

        cum = 1
        n_res = len(cfg.resblock_kernel_sizes)
        for i, u in enumerate(cfg.upsample_rates):
            cum *= u
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            if src is not None:
                # the full-rate source at this stage's rate (stride = the
                # upsampling still to come)
                x = x + _conv_same(src, getattr(self, f"source_{i}"),
                                   stride=cfg.total_upsample // cum)
            acc = None
            for j in range(n_res):
                out = getattr(self, f"resblock_{i}_{j}")(x)
                acc = out if acc is None else acc + out
            x = acc / n_res
        x = _conv_same(F.leaky_relu(x, LRELU_SLOPE), self.conv_post)
        return torch.tanh(x[:, 0])


@torch.no_grad()
def init_generator(model: Generator, generator: torch.Generator) -> Generator:
    """Seeded random weights: normal(0, 1/sqrt(fan_in)), zero biases."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose1d) else w.shape[1]) * w.shape[2]
            w.normal_(0.0, fan_in ** -0.5, generator=generator)
            m.bias.zero_()
    return model
