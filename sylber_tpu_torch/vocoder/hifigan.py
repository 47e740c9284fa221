"""HiFi-GAN: the generator with the optional NSF harmonic source, the
discriminators, the losses and the adversarial train step.

Port of ``sylber_tpu/vocoder/hifigan.py`` (HiFi-GAN v1,
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

Training (:func:`make_vocoder_train_step`): the multi-period discriminator
(the waveform reflect-padded to a multiple of p, or zero-padded where the
pad exceeds L - 1, folded to (L/p, p), 2-D convs (5, 1) at stride (3, 1))
and the multi-scale one (three average-pooled scales, grouped 1-D convs at
flax ``"SAME"`` padding, :func:`_conv_same`, which pads the larger half on
the right where the total is odd, as torch's symmetric padding cannot). A
step updates the discriminators on a detached fake from the old generator,
then the generator against the updated discriminators (LS-GAN,
feature matching times 2, log-mel L1 times 45), both with Adam (b1 0.8, b2
0.99). Discriminator feature maps are channels-first: (B, C, L/p, p) and
(B, C, L) where JAX's are (B, L/p, p, C) and (B, L, C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mel import MelConfig, compute_dtype, log_mel

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
        return F.conv1d(x, conv.weight, conv.bias, stride, left, dilation, conv.groups)
    return F.conv1d(F.pad(x, (left, total - left)), conv.weight, conv.bias, stride, 0, dilation,
                    conv.groups)


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
    drawn from a generator seeded with 0, as JAX draws from ``PRNGKey(0)``).
    float64 features give a float64 source."""
    dt = compute_dtype(features)
    f0 = 100.0 * torch.exp(features[..., cfg.pitch_channel].to(dt))        # (B, T) Hz
    f0_up = torch.repeat_interleave(f0, cfg.total_upsample, dim=1)       # (B, L)
    # the running sum in float64, so that every device rounds it alike
    phase = 2.0 * math.pi * torch.cumsum((f0_up / cfg.sample_rate).double(), dim=1).to(dt)
    h = torch.arange(1, cfg.n_harmonics + 1, dtype=dt, device=features.device)
    sines = torch.sin(phase[..., None] * h)
    alive = (f0_up[..., None] * h) < (cfg.sample_rate / 2.0)
    sines = cfg.source_amp * sines * alive
    if noise is None:
        g = torch.Generator(device=features.device).manual_seed(0)
        noise = torch.randn(f0_up.shape, generator=g, device=features.device)
    return torch.cat([sines, (cfg.source_noise * noise.to(dt))[..., None]], dim=-1)


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
        x = features.to(self.conv_pre.weight.dtype)   # float32, or float64 for a .double() model
        src = None
        if cfg.harmonic_source:
            src = harmonic_noise_source(x, cfg, noise).transpose(1, 2)
        if cfg.cond_channels:
            if cond is None:
                raise ValueError("this generator needs a (B, cond_channels) conditioning")
            x = torch.cat([x, cond.to(x.dtype)[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)
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


# ---------------------------------------------------------------- discriminators

class PeriodDiscriminator(nn.Module):
    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        cin = 1
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, (5, 1), stride=(3, 1), padding=(2, 0)))
            cin = ch
        self.conv_4 = nn.Conv2d(cin, 1024, (5, 1), padding=(2, 0))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor):
        """(B, L) -> (logits (B, *), feature maps [(B, C, L'/p, p)])."""
        B, L = wav.shape
        p = self.period
        pad = (-L) % p
        if pad:
            mode = "reflect" if pad <= L - 1 else "constant"
            wav = F.pad(wav[:, None], (0, pad), mode=mode)[:, 0]
        x = wav.reshape(B, 1, -1, p)
        feats = []
        for i in range(len(self.CHANNELS) + 1):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            feats.append(x)
        return self.conv_post(x).reshape(B, -1), feats


class ScaleDiscriminator(nn.Module):
    # (channels, kernel, stride, groups)
    LAYERS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
              (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (ch, k, _, groups) in enumerate(self.LAYERS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, k, groups=groups))
            cin = ch
        self.conv_post = nn.Conv1d(cin, 1, 3)

    def forward(self, wav: torch.Tensor):
        """(B, L) -> (logits (B, L'), feature maps [(B, C, L_i)])."""
        x = wav[:, None]
        feats = []
        for i, (_, _, stride, _) in enumerate(self.LAYERS):
            x = F.leaky_relu(_conv_same(x, getattr(self, f"conv_{i}"), stride=stride),
                             LRELU_SLOPE)
            feats.append(x)
        return _conv_same(x, self.conv_post)[:, 0], feats


def _avg_pool_same(x: torch.Tensor, window: int = 4, stride: int = 2) -> torch.Tensor:
    """flax ``avg_pool(padding="SAME")`` over (B, L): zeros padded (the
    smaller half on the left) and counted in the mean."""
    L = x.shape[-1]
    out = -(-L // stride)
    total = max((out - 1) * stride + window - L, 0)
    return F.avg_pool1d(F.pad(x[:, None], (total // 2, total - total // 2)), window, stride)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p))

    def forward(self, wav):
        outs = [getattr(self, f"period_{p}")(wav) for p in self.periods]
        return [o[0] for o in outs], [o[1] for o in outs]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"scale_{i}", ScaleDiscriminator())

    def forward(self, wav):
        logits, feats = [], []
        x = wav
        for i in range(self.n_scales):
            if i > 0:
                x = _avg_pool_same(x)
            lg, f = getattr(self, f"scale_{i}")(x)
            logits.append(lg)
            feats.append(f)
        return logits, feats


@torch.no_grad()
def init_discriminator(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: normal(0, 1/sqrt(fan_in)), zero biases."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            m.bias.zero_()
    return model


# ---------------------------------------------------------------- losses, train step

def discriminator_loss(real_logits, fake_logits) -> torch.Tensor:
    """LS-GAN: real -> 1, fake -> 0."""
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + torch.mean((r - 1.0) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adv_loss(fake_logits) -> torch.Tensor:
    return sum(torch.mean((f - 1.0) ** 2) for f in fake_logits)


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            dt = compute_dtype(f)
            loss = loss + torch.mean(torch.abs(r.to(dt) - f.to(dt)))
    return loss


@dataclasses.dataclass(frozen=True)
class VocoderTrainConfig:
    model: HiFiGANConfig = HiFiGANConfig()
    mel: MelConfig = MelConfig()
    lambda_mel: float = 45.0
    lambda_fm: float = 2.0
    lr: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99


@dataclasses.dataclass
class VocoderTrainState:
    generator: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    opt_gen: torch.optim.Adam
    opt_disc: torch.optim.Adam
    step: int = 0

    def discriminators(self) -> List[nn.Module]:
        return [self.mpd, self.msd]


def _discriminate(mpd, msd, wav):
    lp, fp = mpd(wav)
    ls, fs = msd(wav)
    return lp + ls, fp + fs


def discriminator_step_loss(mpd, msd, wav_real: torch.Tensor, wav_fake: torch.Tensor):
    """The discriminators' LS-GAN loss on a real and a (detached) fake batch."""
    real_logits, _ = _discriminate(mpd, msd, wav_real)
    fake_logits, _ = _discriminate(mpd, msd, wav_fake)
    return discriminator_loss(real_logits, fake_logits)


def generator_step_loss(cfg: VocoderTrainConfig, generator, mpd, msd, features, wav_real,
                        cond=None, noise=None):
    """The generator's loss against the discriminators: adversarial +
    ``lambda_fm`` feature matching + ``lambda_mel`` log-mel L1; returns
    ``(loss, {"adv", "fm", "mel_l1"})`` (the real batch's feature maps carry
    no gradient)."""
    fake = generator(features, cond, noise=noise)
    fake_logits, fake_feats = _discriminate(mpd, msd, fake)
    with torch.no_grad():
        _, real_feats = _discriminate(mpd, msd, wav_real)
    adv = generator_adv_loss(fake_logits)
    fm = feature_matching_loss(real_feats, fake_feats)
    mel_l1 = torch.mean(torch.abs(log_mel(fake, cfg.mel) - log_mel(wav_real, cfg.mel)))
    loss = adv + cfg.lambda_fm * fm + cfg.lambda_mel * mel_l1
    return loss, {"adv": adv.detach(), "fm": fm.detach(), "mel_l1": mel_l1.detach()}


def make_vocoder_train_step(cfg: VocoderTrainConfig, precision: str = "default", mesh=None):
    """Returns ``(init_fn, step_fn)`` for adversarial vocoder training.

    ``init_fn(device=None, seed=0, generator_state=None,
    discriminator_state=None) -> VocoderTrainState`` on ``cuda`` unless
    ``device="cpu"``: seeded random weights unless state dicts are given (``io/checkpoint.py`` converts the JAX trees). ``step_fn(state,
    features, wav_real, cond=None, noise=None) -> metrics``: the
    discriminators step on the detached fake of the old generator, then the
    generator against the updated discriminators; ``noise`` is the harmonic
    source's noise channel (B, T * total_upsample). The metrics (``d_loss``,
    ``g_loss``, ``mel_l1``, ``fm``, ``adv``) are device tensors. Convs and
    matmuls run under ``precision`` ("highest": no TF32).

    ``mesh`` (``parallel/mesh.py``, data parallel; the state replicated):
    the inputs are this rank's rows of the global batch, each optimizer's
    gradients are averaged over ``dp`` (the GAN losses are batch means, so
    that is the global batch's gradient) and the metrics are the global
    batch's."""
    from ..parallel.mesh import all_reduce_mean_, reduce_mean
    from ..models.hubert import matmul_precision

    def adam(params):
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)

    def init_fn(device=None, seed: int = 0, generator_state: Optional[Dict] = None,
                discriminator_state: Optional[Dict] = None) -> VocoderTrainState:
        from ..api import resolve_device

        device = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        gen, mpd, msd = Generator(cfg.model), MultiPeriodDiscriminator(), MultiScaleDiscriminator()
        if generator_state is not None:
            gen.load_state_dict(generator_state)
        else:
            init_generator(gen, g)
        if discriminator_state is not None:
            mpd.load_state_dict(discriminator_state["mpd"])
            msd.load_state_dict(discriminator_state["msd"])
        else:
            init_discriminator(mpd, g)
            init_discriminator(msd, g)
        gen, mpd, msd = (m.to(device).train() for m in (gen, mpd, msd))
        disc_params = list(mpd.parameters()) + list(msd.parameters())
        return VocoderTrainState(gen, mpd, msd, adam(gen.parameters()), adam(disc_params))

    def step_fn(state: VocoderTrainState, features: torch.Tensor, wav_real: torch.Tensor,
                cond: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        gen_params = list(state.generator.parameters())
        disc_params = [p for m in state.discriminators() for p in m.parameters()]
        with matmul_precision(precision):
            with torch.no_grad():
                fake = state.generator(features, cond, noise=noise)
            d_loss = discriminator_step_loss(state.mpd, state.msd, wav_real, fake)
            grads = list(torch.autograd.grad(d_loss, disc_params))
            if mesh is not None:
                all_reduce_mean_(grads, mesh.group("dp"), mesh.dp)
            for p, gr in zip(disc_params, grads):
                p.grad = gr
            state.opt_disc.step()
            g_loss, aux = generator_step_loss(cfg, state.generator, state.mpd, state.msd,
                                              features, wav_real, cond, noise)
            grads = list(torch.autograd.grad(g_loss, gen_params))
            if mesh is not None:
                all_reduce_mean_(grads, mesh.group("dp"), mesh.dp)
            for p, gr in zip(gen_params, grads):
                p.grad = gr
            state.opt_gen.step()
        state.step += 1
        return reduce_mean({"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), **aux}, mesh)

    return init_fn, step_fn
