"""Log-mel spectrogram (the vocoder's loss and the card-vs-CPU yardstick).

Port of ``sylber_tpu/vocoder/mel.py``: n_fft 1024, hop 256, window 1024,
80 mels, 0-8000 Hz at 16 kHz, a Slaney-style filterbank built in numpy, a
reflect-padded framing and a Hann window, magnitude of ``torch.fft.rfft``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    eps: float = 1e-5


def _hz_to_mel(f):
    # Slaney scale: linear below 1 kHz, log above
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0), mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0),
                    m * (200.0 / 3.0))


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) Slaney-normalised triangular filterbank."""
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    fb = np.zeros((n_mels, len(bins)))
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
        fb[i] *= 2.0 / max(hi - lo, 1e-9)  # Slaney area normalisation
    return fb.astype(np.float32)


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The vocoder's arithmetic type for ``t``: float64 for float64 (the
    card-against-CPU check of ``chip_smoke.py``), else float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def log_mel(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(B, L) waveform -> (B, frames, n_mels) log-mel spectrogram, in
    float32 (float64 for a float64 waveform)."""
    if cfg.win_length > cfg.n_fft:
        raise ValueError(f"win_length {cfg.win_length} > n_fft {cfg.n_fft}")
    pad = (cfg.n_fft - cfg.hop_length) // 2
    x = torch.nn.functional.pad(wav.to(compute_dtype(wav))[:, None], (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(1, cfg.n_fft, cfg.hop_length)                 # (B, F, n_fft)
    # a win_length window centred in n_fft (torch.stft / librosa semantics)
    w = np.hanning(cfg.win_length + 1)[:-1].astype(np.float32)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    w = np.pad(w, (lpad, cfg.n_fft - cfg.win_length - lpad))
    win = torch.from_numpy(w).to(wav.device, x.dtype)
    spec = torch.abs(torch.fft.rfft(frames * win, dim=-1))
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                         cfg.fmin, cfg.fmax)).to(wav.device, x.dtype)
    mel = torch.einsum("bfk,mk->bfm", spec, fb)
    return torch.log(mel.clamp_min(cfg.eps))
