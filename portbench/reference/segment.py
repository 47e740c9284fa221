"""Sylber's segmentation and pooling, loop by loop, in NumPy.

Copied from ``sylber_tpu_torch/ops/segment_np.py::segment_oracle`` (itself
the reference algorithm) without its margin bookkeeping.

Pass 1, a greedy norm-gated merge scan: a frame whose norm is below the
norm threshold closes the open segment; a voiced frame opens a segment,
extends it (cosine similarity to the running mean >= the merge threshold)
or closes it at a mid boundary. On a mid boundary the frame count carries
on instead of resetting (the reference's quirk). Pass 2 refines each mid
boundary: neighbours whose means are similar merge, otherwise the boundary
moves within a window of half of each neighbour's length to the split that
maximises the summed cosine similarity of the frames to their side's mean
(the first maximum wins). Norms are ``sqrt(sum(x^2) + 1e-8)``.
"""

from __future__ import annotations

import numpy as np


def frame_norms(states: np.ndarray) -> np.ndarray:
    return np.sqrt((states.astype(np.float32) ** 2).sum(-1) + 1e-8)


def _cossim(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    num = (x * y).sum(-1)
    return num / np.sqrt((x ** 2).sum(-1) + 1e-8) / np.sqrt((y ** 2).sum(-1) + 1e-8)


def segment(states: np.ndarray, norm_threshold: float, merge_threshold: float) -> np.ndarray:
    """``(n, 2)`` int64 ``[start, end)`` frames of ``states`` (L, d)."""
    states = np.asarray(states, dtype=np.float32)
    voiced = frame_norms(states) >= norm_threshold
    L = len(states)
    segs, mids = [], []
    curr, cnt, start = None, 0, -1
    for i in range(L):
        if not voiced[i]:
            if start > -1:
                segs.append([start, i])
            start, cnt, curr = -1, 0, None
        elif cnt == 0:
            curr, cnt, start = states[i].copy(), 1, i
        elif _cossim(curr, states[i]) >= merge_threshold:
            curr = (curr * cnt + states[i]) / (cnt + 1)
            cnt += 1
        else:
            segs.append([start, i])
            mids.append((i, len(segs) - 1))
            curr = states[i].copy()
            cnt += 1  # the quirk: the count carries across the boundary
            start = i
    if start > -1:
        segs.append([start, L])

    merged = set()
    for bd, gi in mids:
        if gi >= len(segs) - 1:
            continue
        a0, a1 = segs[gi]
        b0, b1 = segs[gi + 1]
        mean_a, mean_b = states[a0:a1].mean(0), states[b0:b1].mean(0)
        if _cossim(mean_a, mean_b) >= merge_threshold:
            segs[gi + 1] = [a0, b1]
            merged.add(gi)
            continue
        ws = max(a0, bd - max(1, (a1 - a0) // 2))
        we = min(b1, bd + max(1, (b1 - b0) // 2))
        prev = _cossim(states[ws:we], mean_a[None, :])
        nxt = _cossim(states[ws:we], mean_b[None, :])
        sweep = [prev[:j].sum() + nxt[j:].sum() for j in range(we - ws)]
        opt = ws + int(np.argmax(sweep))
        segs[gi], segs[gi + 1] = [a0, opt], [opt, b1]
    out = [s for i, s in enumerate(segs) if i not in merged]
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def pool(states: np.ndarray, segments: np.ndarray) -> np.ndarray:
    """Mean of ``states`` over each ``[start, end)`` of ``segments``."""
    if len(segments) == 0:
        return np.zeros((0, states.shape[-1]), np.float32)
    return np.stack([states[s:e].mean(0) for s, e in segments]).astype(np.float32)
