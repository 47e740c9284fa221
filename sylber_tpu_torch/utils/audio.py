"""Audio loading: WAV, FLAC and OGG read, resample to 16 kHz, normalise.

Port of ``sylber_tpu/utils/audio.py``, with its order of decoders. The
container is told by its magic bytes, not the extension:

- RIFF WAV -> ``scipy.io.wavfile``;
- FLAC (LibriSpeech's format) -> libsndfile when it is found (libFLAC,
  the fastest), else the port's native C++ decoder (``native/flac.cc``,
  built by g++ at first use), else the pure-Python one (``utils/flac.py``);
  all three give the same samples;
- OGG/Vorbis and anything else -> libsndfile (vendored copies are found,
  see ``utils/sndfile.py``), else ``ValueError``.
"""

from __future__ import annotations

from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np

TARGET_SR = 16000


def _load_flac(path: str | Path) -> Tuple[np.ndarray, int]:
    from . import sndfile

    if sndfile.available():
        return sndfile.read(path, dtype="float32")
    with open(path, "rb") as f:
        data = f.read()
    try:
        from .native import NativeUnavailable, decode_flac_native

        pcm, sr, bps = decode_flac_native(data)
    except (NativeUnavailable, ValueError):
        from .flac import FlacError, decode_flac

        try:
            pcm, sr, bps = decode_flac(data)
        except FlacError as e:
            raise FlacError(f"{path}: {e}") from e
    return pcm.astype(np.float32) / float(1 << (bps - 1)), sr


def load_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read an audio file -> (float32 (C, L) in [-1, 1], sample_rate): WAV,
    FLAC, and through libsndfile OGG/Vorbis and its other formats."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return _load_flac(path)
    if magic != b"RIFF":
        from . import sndfile

        try:
            return sndfile.read(path, dtype="float32")
        except sndfile.SndfileUnavailable as e:
            kind = "OGG" if magic == b"OggS" else f"container {magic!r}"
            raise ValueError(f"{path}: {kind} is read only through libsndfile, which "
                             f"failed ({e}); the built-in decoders cover WAV and FLAC") from e
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T  # (C, L)
    return data, int(sr)


def resample(wav: np.ndarray, orig_sr: int, new_sr: int = TARGET_SR) -> np.ndarray:
    if orig_sr == new_sr:
        return wav
    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(wav, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def normalize(wav: np.ndarray) -> np.ndarray:
    """(x - mean) / std with the unbiased std (torch's default)."""
    std = wav.std(ddof=1) if wav.size > 1 else 1.0
    return ((wav - wav.mean()) / (std + 1e-12)).astype(np.float32)


def load_for_inference(path: str | Path) -> np.ndarray:
    """Load + resample to 16 kHz + normalise; returns channel 0 as (L,) float32."""
    wav, sr = load_wav(path)
    wav = normalize(resample(wav, sr))
    return wav[0] if wav.shape[0] >= 1 else wav.reshape(-1)
