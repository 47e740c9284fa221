"""WavLM-style noise and utterance-mix augmentation.

Port of ``sylber_tpu/data/noise.py::mix_noise``, split in two: the random
draws (:func:`noise_draws`, from an explicit ``torch.Generator`` on the
batch's device) and a pure function of them (:func:`mix_noise_apply`), so a
test can feed the JAX package's draws to the port. Per item: a
Bernoulli(``augment_prob``) gate; with probability ``utterance_mix_ratio``
the "noise" is another utterance of the batch under a left or right ramp,
else the given noise clip; the magnitude is uniform in ``magnitude_range``
(``utterance_magnitude_max_scale`` caps it for utterance mixing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class NoiseMixerConfig:
    augment_prob: float = 0.2
    utterance_mix_ratio: float = 0.25
    shift_range: tuple = (0.4, 0.7)
    magnitude_range: tuple = (0.05, 0.7)
    utterance_magnitude_max_scale: float = 0.2


# the draws of one batch, in the order of the JAX function's key split
DRAWS = ("aug", "utt", "perm", "shift", "left", "magnitude", "utt_magnitude")


def noise_draws(generator: torch.Generator, batch: int, device) -> Dict[str, torch.Tensor]:
    """Uniforms (B,) for each draw of :data:`DRAWS` and, for ``perm``, a
    permutation: the order of B more uniforms, an argsort on the device."""
    u = lambda: torch.rand(batch, generator=generator, device=device)  # noqa: E731
    out = {k: u() for k in DRAWS}
    out["perm"] = torch.argsort(out["perm"])
    return out


def mix_noise_apply(wav: torch.Tensor, noise: torch.Tensor, draws: Dict[str, torch.Tensor],
                    cfg: NoiseMixerConfig = NoiseMixerConfig(),
                    source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav, noise: (B, L). Returns the augmented wav. ``source``: the rows
    that ``draws["perm"]`` indexes for utterance mixing (default ``wav``;
    under data parallelism the global batch, of which ``wav`` is a share)."""
    B, L = wav.shape
    dt = wav.dtype
    is_aug = (draws["aug"] <= cfg.augment_prob).to(dt)
    is_utt = (draws["utt"] <= cfg.utterance_mix_ratio).to(dt)
    shuffled = (wav if source is None else source)[draws["perm"]]
    lo, hi = cfg.shift_range
    shift = draws["shift"] * (hi - lo) + lo
    ramp = torch.linspace(0.0, 1.0, L, device=wav.device)[None, :]
    left_mask = (ramp > shift[:, None]).to(dt)
    right_mask = (ramp.flip(-1) > shift[:, None]).to(dt)
    is_left = (draws["left"] >= 0.5).to(dt)[:, None]
    is_utt_c = is_utt[:, None]
    noise = (1 - is_utt_c) * noise + is_utt_c * (
        is_left * left_mask * shuffled + (1 - is_left) * right_mask * shuffled)
    mlo, mhi = cfg.magnitude_range
    magnitude = draws["magnitude"] * (mhi - mlo) + mlo
    utt_mag = draws["utt_magnitude"] * (cfg.utterance_magnitude_max_scale - mlo) + mlo
    magnitude = utt_mag * is_utt + (1 - is_utt) * magnitude
    return wav + is_aug[:, None] * magnitude[:, None] * noise


def mix_noise(generator: torch.Generator, wav: torch.Tensor, noise: torch.Tensor,
              cfg: NoiseMixerConfig = NoiseMixerConfig()) -> torch.Tensor:
    return mix_noise_apply(wav, noise, noise_draws(generator, wav.shape[0], wav.device), cfg)
