"""Corpora drawn from a seed: utterance lengths, a pool of speech, slices.

Every draw comes from ``numpy.random.SeedSequence([seed, stream])``, so any
whole number is a seed, and each stream (the pool, the slices, the weights,
the sample that the check compares, the noise, the row order) is
independent of the others.

The lengths of a corpus are not drawn: they are the quantiles of the mix's
distribution at ``(i + 0.5) / n``, so every seed runs the same shapes and
the same amount of audio, and the seed changes only what is said in them
(which pool utterance, at which offset) and the weights.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import List

import numpy as np

from .synthetic import SR, synth_utterance

# the streams of SeedSequence([seed, stream])
POOL, SLICES, WEIGHTS, SAMPLE, NOISE, ORDER = range(6)


def rng(seed: int, stream: int) -> np.random.RandomState:
    """A numpy generator for ``stream`` of a run seeded ``seed``."""
    return np.random.RandomState(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a torch generator, for ``stream`` of ``seed``."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0]
               & (2 ** 63 - 1))


def lognormal_lengths(n: int, median_s: float, log_sigma: float, lo_s: float,
                      hi_s: float) -> np.ndarray:
    """``n`` lengths in samples: the quantiles of a lognormal (median
    ``median_s`` seconds, ``log_sigma``) at ``(i + 0.5) / n``, clipped to
    ``[lo_s, hi_s]``, longest first."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    secs = np.clip(np.exp(np.log(median_s) + log_sigma * z), lo_s, hi_s)
    return np.sort((secs * SR).astype(np.int64))[::-1].copy()


def speech_pool(seed: int, n_pool: int, pool_s: float) -> List[np.ndarray]:
    """``n_pool`` synthetic utterances of ``pool_s`` seconds (float32)."""
    r = rng(seed, POOL)
    return [synth_utterance(r, int(pool_s * SR)) for _ in range(n_pool)]


def zero_mean_unit_var(x: np.ndarray) -> np.ndarray:
    """The feature extractor's normalisation (biased variance, eps 1e-7)."""
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)


def slices(seed: int, pool: List[np.ndarray], lengths: np.ndarray) -> List[np.ndarray]:
    """One utterance a length: a slice of a pool utterance drawn from the
    seed, at an offset drawn from the seed, normalised."""
    r = rng(seed, SLICES)
    out = []
    for n in lengths:
        src = pool[r.randint(len(pool))]
        off = r.randint(0, len(src) - int(n) + 1)
        out.append(zero_mean_unit_var(src[off: off + int(n)]))
    return out
