"""F0 tracking and per-segment pitch conditioning on the device.

Port of ``sylber_tpu/ops/pitch.py`` (the explicit-pitch path of the
resynthesis chain, ``SynthesisConfig.explicit_pitch_cond``): a batched
normalised-autocorrelation F0 tracker (one framing view, one rFFT/irFFT
pair for every frame, an argmax over the pitch-lag band), the voiced mean of
a frame track over each segment, and the fill of per-segment values back
over the frame grid. Nothing here reads from the device.

The FFTs are ``torch.fft`` (pocketfft on the CPU, cuFFT on the card), whose
rounding differs from XLA's: where two lags of the autocorrelation are
within rounding of each other, the argmax may pick the neighbour, and that
frame's F0 moves by one lag. The tests count such frames.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["frame_f0", "segment_mean_pitch", "fill_segment_values", "segment_pitch_cond"]


def frame_f0(wav: torch.Tensor, sr: int = 16000, frame: int = 1024, hop: int = 320,
             fmin: float = 70.0, fmax: float = 400.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav (B, S) -> (f0 (B, F), strength (B, F)), F = (S - frame) // hop + 1;
    f0 in Hz (0 where the frame has no energy), strength the normalised
    autocorrelation at the chosen lag in [sr / fmax, sr / fmin]."""
    lmin, lmax = int(sr / fmax), int(sr / fmin)
    B, S = wav.shape
    F = max((S - frame) // hop + 1, 0)
    if F == 0:
        empty = wav.new_zeros((B, 0), dtype=torch.float32)
        return empty, empty
    seg = wav.float().unfold(1, frame, hop)[:, :F]           # (B, F, frame)
    seg = seg - seg.mean(-1, keepdim=True)
    n_fft = 2 * frame  # linear, not circular, correlation for lags < frame
    spec = torch.fft.rfft(seg, n=n_fft)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=n_fft)[..., : lmax + 1]
    ac0 = ac[..., 0]
    norm = ac / ac0.clamp_min(1e-9)[..., None]
    lag = lmin + torch.argmax(norm[..., lmin:], dim=-1)
    strength = torch.gather(norm, -1, lag[..., None])[..., 0]
    ok = ac0 > 1e-9
    lag = lag.float()  # a tensor divided, not a number: torch's number / tensor is not IEEE
    f0 = torch.where(ok, torch.full_like(lag, float(sr)) / lag, 0.0)
    return f0, torch.where(ok, strength, 0.0)


def _coverage(segments: torch.Tensor, num_segments: torch.Tensor, length: int,
              has=None) -> torch.Tensor:
    """(B, MS, length) bool: frame t lies in valid segment k."""
    t = torch.arange(length, dtype=torch.int32, device=segments.device)
    s, e = segments[..., 0], segments[..., 1]
    valid = (torch.arange(segments.shape[1], dtype=torch.int32, device=segments.device)[None]
             < num_segments[:, None])
    if has is not None:
        valid = valid & has
    return ((t[None, None, :] >= s[:, :, None]) & (t[None, None, :] < e[:, :, None])
            & valid[:, :, None])


def segment_mean_pitch(values: torch.Tensor, voiced: torch.Tensor, segments: torch.Tensor,
                       num_segments: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voiced mean of ``values`` (B, F) over each segment span: (mean (B, MS),
    has (B, MS)); ``has`` marks segments with a voiced frame (mean 0 else)."""
    cov = _coverage(segments, num_segments, values.shape[1])
    w = (cov & voiced[:, None, :]).to(values.dtype)
    cnt = w.sum(-1)
    mean = (w * values[:, None, :]).sum(-1) / cnt.clamp_min(1.0)
    has = cnt > 0
    return torch.where(has, mean, 0.0), has


def fill_segment_values(values: torch.Tensor, has: torch.Tensor, segments: torch.Tensor,
                        num_segments: torch.Tensor, length: int) -> torch.Tensor:
    """Per-segment scalars (B, MS) over their frame spans (B, length); zeros
    outside segments and for segments with ``has`` False."""
    cov = _coverage(segments, num_segments, length, has)
    seg_id = torch.argmax(cov.to(torch.uint8), dim=1)  # the first covering segment
    filled = torch.gather(values, 1, seg_id)
    return torch.where(cov.any(dim=1), filled, 0.0)


def segment_pitch_cond(wav: torch.Tensor, segments: torch.Tensor, num_segments: torch.Tensor,
                       length: int, pitch_mean: float = 120.0, voiced_threshold: float = 0.4,
                       pitch_quantizer=None) -> torch.Tensor:
    """wav -> frame-filled per-segment mean log(F0 / pitch_mean) (B, length),
    optionally through a discrete pitch quantizer (``get_indices`` /
    ``decode`` on (values, has) pairs)."""
    f0, strength = frame_f0(wav)
    voiced = (strength > voiced_threshold) & (f0 > 0)
    logf0 = torch.where(voiced, torch.log(f0.clamp_min(1.0) / pitch_mean), 0.0)
    mean, has = segment_mean_pitch(logf0, voiced, segments, num_segments)
    if pitch_quantizer is not None:
        mean, has = pitch_quantizer.decode(pitch_quantizer.get_indices(mean, has))
    return fill_segment_values(mean, has, segments, num_segments, length)
