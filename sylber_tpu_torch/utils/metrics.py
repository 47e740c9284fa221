"""Agreement metrics between two segmentations."""

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
