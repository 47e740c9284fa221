"""Agreement metrics: between two segmentations, and of resynthesized pitch."""

from __future__ import annotations

import numpy as np


def boundary_f1(pred: np.ndarray, ref: np.ndarray, tol_frames: int = 1) -> float:
    """F1 over segment boundaries (start and end frames alike): a boundary
    is hit when the other side has one within ``tol_frames``. Two empty
    segmentations agree (1.0); one empty side scores 0."""
    pred = np.unique(np.asarray(pred, np.int64).reshape(-1))
    ref = np.unique(np.asarray(ref, np.int64).reshape(-1))
    if len(pred) == 0 or len(ref) == 0:
        return float(len(pred) == len(ref))
    gap = np.abs(pred[:, None] - ref[None, :])
    precision = float((gap.min(axis=1) <= tol_frames).mean())
    recall = float((gap.min(axis=0) <= tol_frames).mean())
    return 2 * precision * recall / max(precision + recall, 1e-9)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation (1e-12 added to the denominator)."""
    a = a - a.mean()
    b = b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12
    return float((a * b).sum() / den)


def per_utterance_pitch_modulation(art: np.ndarray, truth: np.ndarray,
                                   min_voiced: int = 20) -> float:
    """Mean over utterances of the Pearson correlation of the log-pitch
    channel (12) over voiced frames (truth loudness, channel 13, above 0.02),
    each utterance's mean removed first: the fidelity of the pitch contour
    within an utterance, blind to its register. Utterances with fewer than
    ``min_voiced`` voiced frames are skipped; 0.0 when none is left.
    art, truth: (B, L, >= 14)."""
    rs = []
    for a, t in zip(art, truth):
        v = t[..., 13] > 0.02
        if v.sum() < min_voiced:
            continue
        x = a[..., 12][v] - a[..., 12][v].mean()
        y = t[..., 12][v] - t[..., 12][v].mean()
        den = np.sqrt((x * x).sum() * (y * y).sum()) + 1e-12
        rs.append(float((x * y).sum() / den))
    return float(np.mean(rs)) if rs else 0.0
