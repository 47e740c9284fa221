"""Numpy oracle of the Sylber syllable segmentation.

Port of ``sylber_tpu/ops/segment_np.py``: a direct, loop-by-loop statement of
the reference algorithm, kept as the oracle of the segmentation kernels
(``ops/segment.py``) and of the C++ segmenter (``native/segment.cc``).

Two passes over frame features ``states (L, d)``:

Pass 1, a greedy norm-gated merge scan. A running mean ``curr`` of the open
segment is kept. A frame whose norm falls below ``norm_threshold`` closes the
open segment (silence). A voiced frame opens a segment, extends it (cosine
similarity to the running mean >= ``merge_threshold``), or closes it at a
*mid boundary*. The reference's quirk is kept: on a mid boundary the frame
count ``cnt`` carries on instead of resetting to 1, so the next segment's
running mean is a blend dominated by its first frame.

Pass 2, boundary refinement at the recorded mid boundaries only: two
neighbours whose means are similar merge; otherwise the boundary is swept
over a window of half of each neighbour's length and placed at the split
that maximises the summed cosine similarity of the frames to their side's
mean (the first maximum wins a tie).

Norms are ``sqrt(sum(x^2) + 1e-8)``; the cosine similarity puts the same
epsilon inside each norm.
"""

from __future__ import annotations

import numpy as np


def frame_norms(states: np.ndarray) -> np.ndarray:
    return np.sqrt((states.astype(np.float32) ** 2).sum(-1) + 1e-8)


def _cossim(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    num = (x * y).sum(-1)
    return num / np.sqrt((x ** 2).sum(-1) + 1e-8) / np.sqrt((y ** 2).sum(-1) + 1e-8)


def segment_oracle(
    states: np.ndarray,
    norm_threshold: float,
    merge_threshold: float,
    norms: np.ndarray | None = None,
    return_margin: bool = False,
):
    """Return ``(n_seg, 2)`` int array of ``[start, end)`` frame boundaries.

    With ``return_margin=True`` additionally returns the smallest absolute
    distance of any thresholded decision (norm gate or cosine merge) from its
    threshold — a robustness measure: decisions flip under numerical noise
    only if the noise exceeds this margin.
    """
    states = np.asarray(states, dtype=np.float32)
    if norms is None:
        norms = frame_norms(states)
    voiced = norms >= norm_threshold
    margin = float(np.abs(norms - norm_threshold).min()) if len(norms) else np.inf

    def _track(sim):
        nonlocal margin
        margin = min(margin, abs(float(sim) - merge_threshold))
        return sim

    L = len(states)
    segs: list[list[int]] = []
    mids: list[tuple[int, int]] = []
    curr = None
    cnt = 0
    start = -1

    for i in range(L):
        if not voiced[i]:
            if start > -1:
                segs.append([start, i])
            start = -1
            cnt = 0
            curr = None
        elif cnt == 0:
            curr = states[i].copy()
            cnt = 1
            start = i
        else:
            if _track(_cossim(curr, states[i])) >= merge_threshold:
                curr = (curr * cnt + states[i]) / (cnt + 1)
                cnt += 1
            else:
                segs.append([start, i])
                mids.append((i, len(segs) - 1))
                curr = states[i].copy()
                cnt += 1  # quirk: count carries across the boundary
                start = i
    if start > -1:
        segs.append([start, L])

    merged: set[int] = set()
    for bd, gi in mids:
        if gi >= len(segs) - 1:
            continue
        a0, a1 = segs[gi]
        b0, b1 = segs[gi + 1]
        mean_a = states[a0:a1].mean(0)
        mean_b = states[b0:b1].mean(0)
        if _track(_cossim(mean_a, mean_b)) >= merge_threshold:
            segs[gi + 1] = [a0, b1]
            merged.add(gi)
            continue
        ws = max(a0, bd - max(1, (a1 - a0) // 2))
        we = min(b1, bd + max(1, (b1 - b0) // 2))
        sim_prev = _cossim(states[ws:we], mean_a[None, :])
        sim_next = _cossim(states[ws:we], mean_b[None, :])
        sweep = [sim_prev[:j].sum() + sim_next[j:].sum() for j in range(we - ws)]
        opt = ws + int(np.argmax(sweep))
        segs[gi] = [a0, opt]
        segs[gi + 1] = [opt, b1]

    out = [seg for i, seg in enumerate(segs) if i not in merged]
    result = np.array(out, dtype=np.int64).reshape(-1, 2)
    if return_margin:
        return result, margin
    return result


def pool_segment_features(states: np.ndarray, segments: np.ndarray) -> np.ndarray:
    """Mean-pool raw hidden states over ``[s, e)`` per segment, as the
    reference model pools them."""
    if len(segments) == 0:
        return np.zeros((0, states.shape[-1]), dtype=states.dtype)
    return np.stack([states[s:e].mean(0) for s, e in segments])
