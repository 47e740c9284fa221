"""Two-pass syllable segmentation and segment mean-pooling on tensors.

Port of ``sylber_tpu/ops/segment.py``. On a CUDA tensor the whole
segmentation runs on the card in a fixed number of launches, whatever the
number of segments, and never waits for the host:

- pass 1, the greedy cosine-merge scan: :func:`segment_pass1` launches the
  scan kernel of ``csrc/segment_scan.cu`` (one block per batch row, the frame
  loop inside the block), which emits the per-frame events and fills the
  segment and mid-boundary buffers itself;
- pass 2, the boundary refinement at the recorded mid boundaries, and the
  compaction of the surviving segments: :func:`segment_pass2` launches the
  second kernel of the same source, in which a block splits its row's mid
  boundaries into independent chains (a boundary depends on the one before
  only when its segment index is that one's + 1) and its warps walk them
  concurrently;
- the prefix sums and the mean-pooling are a few torch ops.

On a CPU tensor the two wrappers run their plain versions:
:func:`segment_pass1_plain`, a loop over frames vectorised over the batch,
with the events scattered into the buffers as the JAX code does after its
scan, and :func:`segment_pass2_plain`, a loop over ``range(max(nmid))``
vectorised over the batch (reading that bound from a device tensor would be
a device-to-host sync; the kernel has none).

The reference quirk is kept: on a mid boundary the frame count carries on
instead of resetting (``segment_np.segment_oracle``). Shapes follow the JAX
code: ``MAX_SEGS = L + 1``; all arithmetic is fp32 with 1e-8 inside each norm.

The norm threshold may be a 0-d tensor on the states' device (the trainer's
thresholder): it is only compared on the device. The merge threshold reaches
the kernels as a launch argument, so on a CUDA tensor it must be a host
number (a float or a CPU tensor); a device tensor raises instead of being
read back, which would wait for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import check, lib, require_cuda, stream_of

MAX_DIM = 1024       # csrc/segment_scan.cu: the widest frame its blocks hold
PASS2_WARPS = 8      # csrc/segment_scan.cu: the warps of a pass-2 block
MAX_FRAMES = 1 << 20  # common.cuh: the largest frame count its division is checked for


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
    # the same events as buffers, zero past the counts:
    segs: torch.Tensor         # (B, L + 1, 2) int32: [start, end) in closing order
    nseg: torch.Tensor         # (B,) int32
    mids: torch.Tensor         # (B, L + 1, 2) int32: (frame, index of the segment
    nmid: torch.Tensor         # (B,) int32            closed there) per boundary


def frame_norms(states: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((states.float() ** 2).sum(-1) + 1e-8)


def host_threshold(name: str, value) -> float:
    """``value`` as a float, refusing a tensor on a device: reading it would
    wait for the device, and the kernels take the threshold as an argument."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        raise ValueError(f"{name}: the merge threshold must be a host number, got a "
                         f"tensor on {value.device} (reading it would sync the device)")
    return float(value)


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
    return Pass1Events(close, boundary, seg_start, start,
                       *_event_buffers(close, boundary, seg_start, start))


def _check_states(name: str, states: torch.Tensor) -> None:
    B, L, d = states.shape
    if states.dtype != torch.float32:
        raise ValueError(f"{name}: states must be float32, got {states.dtype}")
    if B < 1 or not 1 <= L <= MAX_FRAMES or not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: states {(B, L, d)}: need at least one row, 1 to "
                         f"{MAX_FRAMES} frames and a width of 1 to {MAX_DIM}")


def segment_pass1(states: torch.Tensor, voiced: torch.Tensor,
                  merge_threshold: float) -> Pass1Events:
    """Pass-1 events and buffers of ``states`` (B, L, d) float32 given
    ``voiced`` (B, L) bool."""
    if states.device.type == "cpu":
        return segment_pass1_plain(states, voiced, merge_threshold)
    B, L, d = states.shape
    _check_states("segment_pass1", states)
    if voiced.dtype != torch.bool or tuple(voiced.shape) != (B, L):
        raise ValueError(f"segment_pass1: voiced must be bool {(B, L)}, got "
                         f"{voiced.dtype} {tuple(voiced.shape)}")
    require_cuda("segment_pass1", states, voiced)
    return _launch_pass1(states, voiced, host_threshold("segment_pass1", merge_threshold))


def _launch_pass1(states, voiced, merge_threshold) -> Pass1Events:
    B, L, d = states.shape
    dev = states.device
    close = torch.empty(B, L, dtype=torch.bool, device=dev)  # the kernel writes 0 or 1
    boundary = torch.empty(B, L, dtype=torch.bool, device=dev)
    seg_start = torch.empty(B, L, dtype=torch.int32, device=dev)
    segs = torch.empty(B, L + 1, 2, dtype=torch.int32, device=dev)
    mids = torch.empty(B, L + 1, 2, dtype=torch.int32, device=dev)
    final_start, nseg, nmid = (torch.empty(B, dtype=torch.int32, device=dev)
                               for _ in range(3))
    check(lib().sylber_segment_pass1(
        states.data_ptr(), voiced.data_ptr(), close.data_ptr(),
        boundary.data_ptr(), seg_start.data_ptr(), final_start.data_ptr(),
        segs.data_ptr(), nseg.data_ptr(), mids.data_ptr(), nmid.data_ptr(),
        B, L, d, merge_threshold, stream_of(states)),
        "segment_pass1")
    segment_pass1.launches += 1
    return Pass1Events(close, boundary, seg_start, final_start, segs, nseg, mids, nmid)


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


def _event_buffers(close, boundary, seg_start, final_start):
    """Scatter the pass-1 events into (segs, nseg, mids, nmid)."""
    B, L = close.shape
    MS = L + 1
    t = torch.arange(L, dtype=torch.int32, device=close.device)[None, :].expand(B, L)
    segs = _scatter_rows(torch.stack([seg_start, t], -1), close, MS)
    nseg = close.sum(dim=1).to(torch.int32)
    pos = (torch.cumsum(close.to(torch.int32), dim=1) - 1).to(torch.int32)
    mids = _scatter_rows(torch.stack([t, pos], -1), boundary, MS)
    nmid = boundary.sum(dim=1).to(torch.int32)

    # close the trailing open segment as [start, L)
    bidx = torch.arange(B, device=close.device)
    trailing = final_start > -1
    tail = torch.stack([final_start, torch.full_like(final_start, L)], -1)
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
    for j in range(int(nmid.max()) if B else 0):  # a host sync off the CPU
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


def segment_pass2_plain(states, norms, P, segs, nseg, mids, nmid, merge_threshold):
    """Reference refinement and compaction: ``_pass2`` then ``_compact``."""
    segs, alive = _pass2(states, norms, P, segs, nseg, mids, nmid, merge_threshold)
    return _compact(segs, nseg, alive)


def segment_pass2(states: torch.Tensor, norms: torch.Tensor, P: torch.Tensor,
                  segs: torch.Tensor, nseg: torch.Tensor, mids: torch.Tensor,
                  nmid: torch.Tensor, merge_threshold: float):
    """Refine the pass-1 segments at their mid boundaries and compact them.

    ``states`` (B, L, d) and ``norms`` (B, L) float32, ``P`` (B, L + 1, d) the
    prefix sums of ``states``; ``segs``, ``nseg``, ``mids``, ``nmid`` as
    :func:`segment_pass1` returns them (they are left as they are). Returns
    ``(segments, num_segments)``: (B, L + 1, 2) int32, zero past the count,
    and (B,) int32.
    """
    if states.device.type == "cpu":
        return segment_pass2_plain(states, norms, P, segs, nseg, mids, nmid,
                                   merge_threshold)
    B, L, d = states.shape
    _check_states("segment_pass2", states)
    for name, t, shape, dtype in (
            ("norms", norms, (B, L), torch.float32), ("P", P, (B, L + 1, d), torch.float32),
            ("segs", segs, (B, L + 1, 2), torch.int32), ("nseg", nseg, (B,), torch.int32),
            ("mids", mids, (B, L + 1, 2), torch.int32), ("nmid", nmid, (B,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"segment_pass2: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    require_cuda("segment_pass2", states, norms, P, segs, nseg, mids, nmid)
    return _launch_pass2(states, norms, P, segs, nseg, mids, nmid,
                         host_threshold("segment_pass2", merge_threshold))


def _launch_pass2(states, norms, P, segs, nseg, mids, nmid, merge_threshold):
    B, L, d = states.shape
    dev = states.device
    work = torch.empty_like(segs)  # the row's segments while they are refined
    chains = torch.empty(B, 2, L + 1, dtype=torch.int32, device=dev)  # starts, queue
    # a warp's cosines of a sweep window too long for its shared memory
    win = torch.empty(B, PASS2_WARPS, 2, L, dtype=torch.float32, device=dev)
    out = torch.empty_like(segs)
    nout = torch.empty_like(nseg)
    check(lib().sylber_segment_pass2(
        states.data_ptr(), norms.data_ptr(), P.data_ptr(), segs.data_ptr(),
        nseg.data_ptr(), mids.data_ptr(), nmid.data_ptr(), work.data_ptr(),
        chains.data_ptr(), win.data_ptr(), out.data_ptr(), nout.data_ptr(), B, L, d,
        merge_threshold, stream_of(states)), "segment_pass2")
    segment_pass2.launches += 1
    return out, nout


segment_pass2.launches = 0


def _segment_means(P: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """Mean of states over each [s, e) from prefix sums, (B, MS, d)."""
    bidx = torch.arange(P.shape[0], device=P.device)[:, None]
    s, e = segments[..., 0].long(), segments[..., 1].long()
    length = (e - s).clamp_min(1).float()
    return (P[bidx, e] - P[bidx, s]) / length[..., None]


def segment_batch(states: torch.Tensor, norm_threshold, merge_threshold,
                  frame_valid: Optional[torch.Tensor] = None,
                  norms: Optional[torch.Tensor] = None) -> SegmentResult:
    """Segment a batch of frame features ``states`` (B, L, d).

    ``norm_threshold``: a number or a 0-d tensor on the states' device;
    ``merge_threshold``: a number (or, on the CPU, any scalar tensor).
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
    p1 = segment_pass1(states, voiced.contiguous(), merge_threshold)
    segs, n = segment_pass2(states, norms.contiguous(), P, p1.segs, p1.nseg,
                            p1.mids, p1.nmid, merge_threshold)

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
