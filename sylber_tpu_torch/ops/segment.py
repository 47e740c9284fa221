"""Two-pass syllable segmentation and segment mean-pooling on tensors.

Port of ``sylber_tpu/ops/segment.py``:

- pass 1, the greedy cosine-merge scan, emits per-frame events. On a CUDA
  tensor :func:`segment_pass1` launches the kernel of
  ``csrc/segment_scan.cu`` (one block per batch row, the frame loop inside
  the block); on a CPU tensor it runs :func:`segment_pass1_plain`, a loop
  over frames vectorised over the batch. The events are scattered into
  segment buffers with torch ops, as the JAX code does after its scan.
- pass 2, the boundary refinement at recorded mid boundaries, is a loop of
  torch ops over ``range(max(nmid))``. Reading that bound is one
  device-to-host sync per batch.
- compaction and prefix-sum pooling are torch ops.

The reference quirk is kept: on a mid boundary the frame count carries on
instead of resetting (``segment_np.segment_oracle``). Shapes follow the JAX
code: ``MAX_SEGS = L + 1``; all arithmetic is fp32 with 1e-8 inside each norm.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import check, lib, require_cuda, stream_of

MAX_DIM = 1024  # csrc/segment_scan.cu: 256 threads x 4 lanes


class SegmentResult(NamedTuple):
    segments: torch.Tensor      # (B, MAX_SEGS, 2) int32, [start, end) frames
    num_segments: torch.Tensor  # (B,) int32
    features: torch.Tensor      # (B, MAX_SEGS, d) float32 mean-pooled states
    norms: torch.Tensor         # (B, L) float32 frame norms


class Pass1Events(NamedTuple):
    close: torch.Tensor        # (B, L) bool: a segment [seg_start, t) closes at t
    boundary: torch.Tensor     # (B, L) bool: ... and t is a mid boundary
    seg_start: torch.Tensor    # (B, L) int32: open segment's start before frame t
    final_start: torch.Tensor  # (B,) int32: start of the segment open at the end


def frame_norms(states: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((states.float() ** 2).sum(-1) + 1e-8)


def _vec_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x ** 2).sum(-1) + 1e-8)


def segment_pass1_plain(states: torch.Tensor, voiced: torch.Tensor,
                        merge_threshold: float) -> Pass1Events:
    """Reference scan: one step per frame, vectorised over the batch."""
    B, L, d = states.shape
    dev = states.device
    curr = torch.zeros(B, d, dtype=torch.float32, device=dev)
    cnt = torch.zeros(B, dtype=torch.float32, device=dev)
    start = torch.full((B,), -1, dtype=torch.int32, device=dev)
    close = torch.zeros(B, L, dtype=torch.bool, device=dev)
    boundary = torch.zeros(B, L, dtype=torch.bool, device=dev)
    seg_start = torch.empty(B, L, dtype=torch.int32, device=dev)
    for i in range(L):
        x, v = states[:, i], voiced[:, i]
        sim = (curr * x).sum(-1) / _vec_norm(curr) / _vec_norm(x)
        is_first = cnt == 0
        merge = sim >= merge_threshold
        bnd = v & ~is_first & ~merge
        close[:, i] = (~v & (start > -1)) | bnd
        boundary[:, i] = bnd
        seg_start[:, i] = start
        merged = (curr * cnt[:, None] + x) / (cnt[:, None] + 1.0)
        curr = torch.where(v[:, None],
                           torch.where((merge & ~is_first)[:, None], merged, x),
                           torch.zeros_like(x))
        cnt = torch.where(v, torch.where(is_first, torch.ones_like(cnt), cnt + 1.0),
                          torch.zeros_like(cnt))
        start = torch.where(v, torch.where(is_first | bnd, torch.full_like(start, i),
                                           start),
                            torch.full_like(start, -1))
    return Pass1Events(close, boundary, seg_start, start)


def segment_pass1(states: torch.Tensor, voiced: torch.Tensor,
                  merge_threshold: float) -> Pass1Events:
    """Pass-1 events of ``states`` (B, L, d) float32 given ``voiced`` (B, L) bool."""
    if states.device.type == "cpu":
        return segment_pass1_plain(states, voiced, merge_threshold)
    B, L, d = states.shape
    if states.dtype != torch.float32 or voiced.dtype != torch.bool:
        raise ValueError("segment_pass1: states float32 and voiced bool expected")
    if tuple(voiced.shape) != (B, L):
        raise ValueError(f"segment_pass1: voiced {tuple(voiced.shape)} != {(B, L)}")
    if d > MAX_DIM:
        raise ValueError(f"segment_pass1: feature width {d} > {MAX_DIM}")
    require_cuda("segment_pass1", states, voiced)
    dev = states.device
    close = torch.empty(B, L, dtype=torch.uint8, device=dev)
    boundary = torch.empty(B, L, dtype=torch.uint8, device=dev)
    seg_start = torch.empty(B, L, dtype=torch.int32, device=dev)
    final_start = torch.empty(B, dtype=torch.int32, device=dev)
    check(lib().sylber_segment_pass1(
        states.data_ptr(), voiced.data_ptr(), close.data_ptr(),
        boundary.data_ptr(), seg_start.data_ptr(), final_start.data_ptr(),
        B, L, d, float(merge_threshold), stream_of(states)), "segment_pass1")
    segment_pass1.launches += 1
    return Pass1Events(close.bool(), boundary.bool(), seg_start, final_start)


segment_pass1.launches = 0


def _scatter_rows(values: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """Order-preserving compaction: row t of ``values`` (B, L, 2) goes to slot
    ``cumsum(keep)[t] - 1`` of a zero (B, size, 2) buffer when ``keep[b, t]``."""
    B, L, _ = values.shape
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, pos, torch.full_like(pos, size))  # size = dropped
    out = torch.zeros(B, size + 1, 2, dtype=values.dtype, device=values.device)
    out.scatter_(1, dest[..., None].expand(B, L, 2), values)
    return out[:, :size]


def _pass1(states, voiced, merge_threshold):
    B, L, _ = states.shape
    MS = L + 1
    ev = segment_pass1(states, voiced, merge_threshold)
    t = torch.arange(L, dtype=torch.int32, device=states.device)[None, :].expand(B, L)
    segs = _scatter_rows(torch.stack([ev.seg_start, t], -1), ev.close, MS)
    nseg = ev.close.sum(dim=1).to(torch.int32)
    pos = (torch.cumsum(ev.close.to(torch.int32), dim=1) - 1).to(torch.int32)
    mids = _scatter_rows(torch.stack([t, pos], -1), ev.boundary, MS)
    nmid = ev.boundary.sum(dim=1).to(torch.int32)

    # close the trailing open segment as [start, L)
    bidx = torch.arange(B, device=states.device)
    trailing = ev.final_start > -1
    tail = torch.stack([ev.final_start, torch.full_like(ev.final_start, L)], -1)
    idx = nseg.long()
    segs[bidx, idx] = torch.where(trailing[:, None], tail, segs[bidx, idx])
    return segs, nseg + trailing.to(torch.int32), mids, nmid


def _prefix_sums(states: torch.Tensor) -> torch.Tensor:
    """P[:, t] = sum(states[:, :t]) in fp32, (B, L + 1, d)."""
    B, _, d = states.shape
    zero = torch.zeros(B, 1, d, dtype=torch.float32, device=states.device)
    return torch.cat([zero, torch.cumsum(states, dim=1)], dim=1)


def _pass2(states, norms, P, segs, nseg, mids, nmid, merge_threshold):
    B, L, _ = states.shape
    MS = segs.shape[1]
    dev = states.device
    bidx = torch.arange(B, device=dev)
    u = torch.arange(L, device=dev)[None, :]
    alive = torch.ones(B, MS, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, 1, dtype=torch.float32, device=dev)
    segs = segs.clone()
    for j in range(int(nmid.max()) if B else 0):  # the one host sync
        bd = mids[:, j, 0].long()
        gi = mids[:, j, 1].long().clamp(0, MS - 2)
        active = (j < nmid) & (mids[:, j, 1] < nseg - 1)

        a, b = segs[bidx, gi], segs[bidx, gi + 1]
        a0, a1, b0, b1 = (c.long() for c in (a[:, 0], a[:, 1], b[:, 0], b[:, 1]))
        len_a = (a1 - a0).clamp_min(1).float()
        len_b = (b1 - b0).clamp_min(1).float()
        mean_a = (P[bidx, a1] - P[bidx, a0]) / len_a[:, None]
        mean_b = (P[bidx, b1] - P[bidx, b0]) / len_b[:, None]
        sim_ab = (mean_a * mean_b).sum(-1) / _vec_norm(mean_a) / _vec_norm(mean_b)

        do_merge = active & (sim_ab >= merge_threshold)
        do_sweep = active & ~do_merge

        # boundary sweep window [ws, we)
        ws = torch.maximum(a0, bd - ((a1 - a0) // 2).clamp_min(1))
        we = torch.minimum(b1, bd + ((b1 - b0) // 2).clamp_min(1))
        cp = torch.einsum("bld,bd->bl", states, mean_a) / (
            norms * _vec_norm(mean_a)[:, None])
        cn = torch.einsum("bld,bd->bl", states, mean_b) / (
            norms * _vec_norm(mean_b)[:, None])
        inw = (u >= ws[:, None]) & (u < we[:, None])
        CP = torch.cat([zero, torch.cumsum(torch.where(inw, cp, 0.0), dim=1)], 1)
        CN = torch.cat([zero, torch.cumsum(torch.where(inw, cn, 0.0), dim=1)], 1)
        # score(t) = sum_{ws<=uu<t} cp[uu] + sum_{t<=uu<we} cn[uu]
        score = (CP[:, :L] - CP[bidx, ws][:, None]) + (CN[bidx, we][:, None] - CN[:, :L])
        score = torch.where(inw, score, float("-inf"))
        opt = torch.argmax(score, dim=1).to(torch.int32)

        new_a = torch.where(do_sweep[:, None], torch.stack([a[:, 0], opt], -1), a)
        new_b = torch.where(
            do_merge[:, None], torch.stack([a[:, 0], b[:, 1]], -1),
            torch.where(do_sweep[:, None], torch.stack([opt, b[:, 1]], -1), b))
        segs[bidx, gi] = new_a
        segs[bidx, gi + 1] = new_b
        alive[bidx, gi] = torch.where(do_merge, False, alive[bidx, gi])
    return segs, alive


def _compact(segs, nseg, alive):
    _, MS, _ = segs.shape
    valid = alive & (torch.arange(MS, device=segs.device)[None, :] < nseg[:, None])
    return _scatter_rows(segs, valid, MS), valid.sum(dim=1).to(torch.int32)


def _segment_means(P: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """Mean of states over each [s, e) from prefix sums, (B, MS, d)."""
    bidx = torch.arange(P.shape[0], device=P.device)[:, None]
    s, e = segments[..., 0].long(), segments[..., 1].long()
    length = (e - s).clamp_min(1).float()
    return (P[bidx, e] - P[bidx, s]) / length[..., None]


def segment_batch(states: torch.Tensor, norm_threshold: float,
                  merge_threshold: float,
                  frame_valid: Optional[torch.Tensor] = None,
                  norms: Optional[torch.Tensor] = None) -> SegmentResult:
    """Segment a batch of frame features ``states`` (B, L, d).

    ``frame_valid`` (B, L) bool marks padded frames False; they count as
    silence, so batched results equal single-utterance results. Returns the
    compacted, order-preserved segments and their mean-pooled features.
    """
    states = states.float().contiguous()
    if norms is None:
        norms = frame_norms(states)
    voiced = norms >= norm_threshold
    if frame_valid is not None:
        voiced = voiced & frame_valid
    P = _prefix_sums(states)
    segs, nseg, mids, nmid = _pass1(states, voiced.contiguous(), merge_threshold)
    segs, alive = _pass2(states, norms, P, segs, nseg, mids, nmid, merge_threshold)
    segs, n = _compact(segs, nseg, alive)

    # mean-pool hidden states over each [s, e)
    MS = segs.shape[1]
    seg_valid = torch.arange(MS, device=states.device)[None, :] < n[:, None]
    feats = torch.where(seg_valid[..., None], _segment_means(P, segs), 0.0)
    return SegmentResult(segs, n, feats, norms)


def averaged_target_fill(states: torch.Tensor, segments: torch.Tensor,
                         num_segments: torch.Tensor) -> torch.Tensor:
    """Frame-level tensor where each frame inside segment k holds that
    segment's mean, and frames outside every segment hold 0 (the
    distillation target)."""
    B, L, _ = states.shape
    MS = segments.shape[1]
    means = _segment_means(_prefix_sums(states.float()), segments)
    seg_valid = torch.arange(MS, device=states.device)[None, :] < num_segments[:, None]
    t = torch.arange(L, device=states.device)
    s, e = segments[..., 0], segments[..., 1]
    covered = ((t[None, None, :] >= s[:, :, None]) & (t[None, None, :] < e[:, :, None])
               & seg_valid[:, :, None])                       # (B, MS, L)
    seg_id = torch.argmax(covered.to(torch.uint8), dim=1)    # first covering segment
    filled = torch.gather(means, 1, seg_id[..., None].expand(B, L, means.shape[-1]))
    return torch.where(covered.any(dim=1)[..., None], filled, 0.0)
