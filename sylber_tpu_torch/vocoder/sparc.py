"""Articulatory decoder: SegmentSynthesis output -> waveform.

Port of ``sylber_tpu/vocoder/sparc.py``: a HiFi-GAN :class:`Generator`
conditioned on the 14 articulatory channels and a global speaker embedding,
with the reference demo's pitch handling (``coder.decode(ema, exp(pitch) *
pitch_mean, loudness, spk_emb)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..api import resolve_device
from ..io.checkpoint import generator_state_dict_from_jax
from ..models.hubert import matmul_precision
from .hifigan import Generator, HiFiGANConfig, init_generator


def features_from_art(art: torch.Tensor, pitch_mean: float = 120.0,
                      n_ema: int = 12) -> torch.Tensor:
    """The generator's input from articulatory tracks: EMA dims pass through;
    the log-pitch channel becomes log(max(exp(pitch) * pitch_mean, 1) / 100);
    loudness passes through."""
    art = art.float()
    pitch_hz = torch.exp(art[..., n_ema]) * pitch_mean
    pitch_feat = torch.log(pitch_hz.clamp_min(1.0) / 100.0)
    return torch.cat([art[..., :n_ema], pitch_feat[..., None], art[..., n_ema + 1:n_ema + 2]],
                     dim=-1)


@dataclasses.dataclass(frozen=True)
class SparcDecoderConfig:
    n_ema: int = 12
    spk_emb_dim: int = 64
    generator: HiFiGANConfig = HiFiGANConfig(in_channels=14, cond_channels=64)


class SparcDecoder:
    """``decoder(art, spk_emb, pitch_mean)`` -> 16 kHz waveform (numpy).

    ``art``: (B, T, 14) from ``SegmentSynthesis.resynthesize`` (log-pitch in
    its natural scale); ``spk_emb``: (B, spk_emb_dim); ``pitch_mean``: the
    speaker's mean F0 in Hz. Weights: ``params``, the JAX generator tree of
    numpy arrays; ``state_dict``, the port generator's (a converted torch
    checkpoint, ``io/torch_convert.py::hifigan_params_from_torch``); neither:
    seeded random weights, and ``random_init`` is set (they emit noise).
    ``precision``: "default" lets cuDNN's convs run in TF32 on the card,
    "highest" holds them to fp32 (the parity scope)."""

    def __init__(self, config: Optional[SparcDecoderConfig] = None,
                 params: Optional[Mapping[str, Any]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 device: Union[None, str, torch.device] = None, precision: str = "default"):
        self.device = resolve_device(device)
        self.precision = precision
        self.config = config or SparcDecoderConfig()
        gcfg = self.config.generator
        if gcfg.in_channels != self.config.n_ema + 2 or \
                gcfg.cond_channels != self.config.spk_emb_dim:
            raise ValueError("generator in_channels must be n_ema + 2 and cond_channels "
                             "spk_emb_dim")
        self.generator = Generator(gcfg)
        self.random_init = params is None and state_dict is None
        if params is not None:
            state_dict = generator_state_dict_from_jax(params)
        if state_dict is not None:
            self.generator.load_state_dict(state_dict)
        else:
            init_generator(self.generator, torch.Generator().manual_seed(seed))
        self.generator.to(self.device).eval()

    def features_from_art(self, art: torch.Tensor, pitch_mean: float = 120.0) -> torch.Tensor:
        return features_from_art(art, pitch_mean, self.config.n_ema)

    @torch.inference_mode()
    def waveform(self, art, spk_emb, pitch_mean: float = 120.0,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The waveform on the device, (B, T * 320)."""
        art = torch.as_tensor(art, dtype=torch.float32).to(self.device)
        if art.ndim == 2:
            art = art[None]
        spk = torch.as_tensor(spk_emb, dtype=torch.float32).to(self.device)
        if spk.ndim == 1:
            spk = spk[None]
        with matmul_precision(self.precision):
            return self.generator(self.features_from_art(art, pitch_mean), spk, noise=noise)

    def __call__(self, art, spk_emb, pitch_mean: float = 120.0) -> np.ndarray:
        return self.waveform(art, spk_emb, pitch_mean).cpu().numpy()


def load_decoder(ckpt: str, config: Optional[SparcDecoderConfig] = None,
                 device: Union[None, str, torch.device] = None) -> SparcDecoder:
    """A trained ``SparcDecoder`` from ``ckpt``: a JAX-layout generator
    ``.npz`` or a torch HiFi-GAN generator checkpoint (a state dict, or a
    dict holding one under ``"generator"``), at ``config``'s widths
    (``SparcDecoderConfig()`` by default). An Orbax directory raises."""
    from pathlib import Path

    config = config or SparcDecoderConfig()
    if ckpt.endswith(".npz"):
        from ..io.checkpoint import load_params_npz

        return SparcDecoder(config, params=load_params_npz(ckpt), device=device)
    if Path(ckpt).is_dir():
        raise NotImplementedError(f"{ckpt}: Orbax directories need JAX; pass a .npz or a "
                                  "torch generator checkpoint")
    from ..io.torch_convert import hifigan_params_from_torch, torch_load

    sd = torch_load(ckpt)
    if isinstance(sd, dict) and "generator" in sd:
        sd = sd["generator"]
    return SparcDecoder(config, state_dict=hifigan_params_from_torch(sd, config.generator),
                        device=device)
