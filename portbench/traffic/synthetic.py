"""Synthetic speech, the benchmark's frozen copy of the generator.

Copied from ``sylber_tpu_torch/data/synthetic.py`` (the ``"v1"`` style,
which the corpora of the benchmark use), so that a change to the program's
generator does not change the benchmark's audio. It draws the same random
numbers in the same order as the original; the harmonic sum of a syllable
is taken by the recurrence ``sin((k + 1) p) = 2 cos(p) sin(k p) - sin((k - 1) p)``
instead of one ``sin`` per harmonic, which gives the same audio to float64
rounding and takes a tenth of the host time.

Each utterance is a sequence of syllables: a voiced span with a declining
pitch whose harmonics are shaped by a pair of formant resonances drawn from
a fixed bank, under a raised-cosine envelope, separated by short closures
and occasional longer silences, plus a little white noise.
"""

from __future__ import annotations

import numpy as np

SR = 16000
FRAME = 320  # 50 Hz

_BANK_RNG = np.random.RandomState(20240901)
FORMANT_BANK = np.stack([
    _BANK_RNG.uniform(280, 900, 40),     # F1
    _BANK_RNG.uniform(900, 2800, 40),    # F2
], axis=1)


def _syllable(n: int, f0: float, formants: np.ndarray) -> np.ndarray:
    t = np.arange(n) / SR
    f0_t = f0 * (1.0 - 0.08 * t / max(t[-1], 1e-6)) * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t))
    phase = np.cumsum(2 * np.pi * f0_t / SR)
    max_h = int(3500 / f0)
    k = np.arange(1, max_h + 1)
    amp = sum(1.0 / (1.0 + ((k * f0 - fc) / 120.0) ** 2) for fc in formants) / k ** 0.5
    x = np.zeros(n)
    prev, cur, twice_cos = np.zeros(n), np.sin(phase), 2.0 * np.cos(phase)
    for a in amp:
        x += a * cur
        prev, cur = cur, twice_cos * cur - prev
    x /= np.abs(x).max() + 1e-9
    tau = np.linspace(0, 1, n)
    env = np.sin(np.pi * tau ** 0.8) ** 0.7
    return (x * env).astype(np.float32)


def synth_utterance(rng: np.random.RandomState, n_samples: int,
                    f0_range=(100.0, 240.0), noise_level: float = 0.003) -> np.ndarray:
    """``n_samples`` of float32 speech-like audio drawn from ``rng``."""
    wav = np.zeros(n_samples, np.float32)
    f0_base = rng.uniform(*f0_range)
    pos = rng.randint(0, 3) * FRAME  # small lead-in silence
    while pos < n_samples - 4 * FRAME:
        dur_frames = int(rng.uniform(6, 15))  # 120-300 ms
        dur = dur_frames * FRAME
        if pos + dur > n_samples:
            dur = (n_samples - pos) // FRAME * FRAME
            if dur // FRAME < 4:
                break
        phoneme = FORMANT_BANK[rng.randint(len(FORMANT_BANK))]
        f0 = f0_base * rng.uniform(0.85, 1.2)
        amp = rng.uniform(0.5, 1.0)
        wav[pos: pos + dur] = amp * _syllable(dur, f0, phoneme)
        pos += dur
        # a word boundary: 20 % a silence of 60-200 ms, else a closure of 0-1 frames
        if rng.rand() < 0.2:
            pos += int(rng.uniform(3, 10)) * FRAME
        else:
            pos += rng.randint(0, 2) * FRAME
    wav += noise_level * rng.randn(n_samples).astype(np.float32)
    return wav
