#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sylber_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the script when it fails:

1. build the CUDA kernels of ``sylber_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes and layout, fp32 and bf16, with ragged key lengths and
   a fully padded item; time the kernel, the plain version and, as a
   yardstick only, one PyTorch library call computing the same function
   (all three on the same tensors); then hold the two
   attention kernels against their plain versions at the awkward shapes
   (sequence lengths off the tile, head widths 12 to 128, key lengths at the
   tile edges, a scale override, contiguous and strided ``(B, L, H, D)`` views),
   conv0 on a DC offset, an all-zero item and the 20 s bucket, the whole
   segmentation at awkward lengths, widths and rows, and the division of
   pass 1's merged mean against the IEEE division for every frame count;
3. run the ``Segmenter`` at full hubert-base width (768 wide, 9 layers,
   seeded random weights) in fp32 parity mode and bf16 fast mode on a
   32 x 5 s batch (small-attention path) and a 32 x 12-20 s batch (flash
   path), with every launch counter set to 0 just before and read just
   after; every kernel must have launched; the segmentation runs with
   ``torch.cuda.set_sync_debug_mode("error")``, so a wait for the host
   inside it fails the run; prints the real-time factor of five timed calls;
4. run the trained ``tests/fixtures/mini_ckpt.npz`` Segmenter on the card
   and on the CPU; the segments must be identical; then its bf16 fast mode
   against its fp32 parity mode, both on the card: boundary F1 at tolerance
   0 must reach 0.995.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
(``nvidia-smi``), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 tensor cores
# Least dependent latency of one frame of the pass-1 scan, in SM cycles, from
# assumed (not measured) instruction latencies: 4 for a dependent fp32 add,
# multiply or FMA, 24 for a warp shuffle, 40 for an IEEE square root or
# division. One product (4), a reduction across a warp's lanes (5 x (24 + 4)),
# the square root of |curr|^2 (40), two divisions (80), compare and select
# (8), the update of the mean (4 + 4 + 40).
PASS1_CHAIN_CYCLES = 4 + 5 * (24 + 4) + 40 + 80 + 8 + 48


def log(*parts):
    print(*parts, flush=True)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """Least time for the work: the larger of its bytes over the memory rate
    and its operations over the peak rate for its type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(torch, fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so that a short kernel is not timed by the host that enqueues it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, 3, warmup=1) / reps


def speechlike(rng, n: int) -> np.ndarray:
    """Harmonic voiced stretches with a syllable-rate envelope and pauses."""
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = sum(np.sin(k * phase + rng.rand() * 6.28) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3.5, 5) * t + rng.rand() * 6.28), 0, None)
    gate = (np.sin(2 * np.pi * 0.4 * t + rng.rand() * 6.28) > -0.5).astype(float)
    wav = sig * env * gate + 0.01 * rng.randn(n)
    return ((wav - wav.mean()) / wav.std(ddof=1)).astype(np.float32)


def synthetic_states(rng, B, L, d):
    """Syllable-like plateaus separated by low-norm gaps, (B, L, d)."""
    out = np.zeros((B, L, d), np.float32)
    for b in range(B):
        i = 0
        while i < L:
            span = min(int(rng.randint(2, 14)), L - i)
            if rng.rand() < 0.25:
                out[b, i:i + span] = rng.randn(span, d) * 0.05
            else:
                proto = rng.randn(d)
                proto *= rng.uniform(4.0, 9.0) / np.linalg.norm(proto)
                out[b, i:i + span] = proto + rng.randn(span, d) * 0.15
            i += span
    return out


# ---------------------------------------------------------------- phase 2

def check_kernels(torch, ops):
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    results = {}

    # conv0 + GroupNorm + GELU at B=32 x 5 s
    B, L, D = 32, 80000, 512
    x = randn(B, L)
    x[5, 40000:] = 0.0  # a padded item: padding enters the moments
    w = randn(D, 1, 10) / 10 ** 0.5
    gamma, beta = 1 + 0.1 * randn(D), 0.1 * randn(D)
    T0 = (L - 10) // 5 + 1
    rec = {}
    for dt, tol in (("float32", 2e-4), ("bfloat16", 2e-2)):
        tdt = getattr(torch, dt)
        run = lambda: ops.frontend.conv0_gn_gelu(x, w, gamma, beta, out_dtype=tdt)  # noqa: E731
        plain = lambda: ops.frontend.conv0_gn_gelu_plain(x, w, gamma, beta, out_dtype=tdt)  # noqa: E731
        library = lambda: F.gelu(F.group_norm(F.conv1d(x[:, None], w, stride=5), D,  # noqa: E731
                                              gamma, beta)).to(tdt)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        nbytes = 4 * (B * L + D * 12) + B * T0 * D * got.element_size()
        b_ms, b_by = bound_ms(nbytes, B * T0 * D * (2 * 10 + 4), "float32")
        rec[dt] = dict(max_abs_err=err, tol=tol, ok=bool(ok),
                       ms=graph_time_ms(torch, run, 5), plain_ms=time_ms(torch, plain, 5),
                       library_ms=time_ms(torch, library, 5), eager_ms=time_ms(torch, run, 10),
                       bound_ms=b_ms, bound_by=b_by, shape=[B, L, D])
        del got, want
    results["conv0_gn_gelu"] = rec

    # attention: small path at L=250, flash path at L=1000
    for name, L, fn, plain_fn in (
            ("small_attention", 250, ops.smallattn.small_attention,
             ops.smallattn.small_attention_plain),
            ("flash_attention", 1000, ops.flash.flash_attention,
             ops.flash.flash_attention_plain)):
        B, H, Dh = 32, 12, 64
        lens = torch.randint(L // 2, L + 1, (B,), device=dev, generator=gen).to(torch.int32)
        lens[0], lens[1] = L, 0  # a full item and a fully padded one
        keep = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        rec = {}
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            tdt = getattr(torch, dt)
            # (B, H, L, D) views of (B, L, H, D) memory, as the encoder layer
            # hands its projections to the kernels
            q, k, v = (randn(B, L, H, Dh).to(tdt).transpose(1, 2) for _ in range(3))
            run = lambda: fn(q, k, v, lens)  # noqa: E731
            plain = lambda: plain_fn(q, k, v, lens)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            # q read and o written in full; K and V only up to kv_len[b], which
            # is where the key loop ends. An item with no valid key needs all
            # of V in the small kernel (the mean of V) and nothing in flash.
            kv_rows = 2 * int(lens.sum().item())
            if name == "small_attention":
                kv_rows += L * int((lens == 0).sum().item())
            nbytes = (2 * B * L + kv_rows) * H * Dh * q.element_size() + 4 * B
            ops_n = 4.0 * H * Dh * L * float(lens.sum().item())
            b_ms, b_by = bound_ms(nbytes, ops_n, dt)
            # device times by graph replay: the small kernel is shorter than
            # the host's work to enqueue it; eager_ms is the wrapper as called
            rec[dt] = dict(max_abs_err=err, tol=tol, ok=bool(ok),
                           ms=graph_time_ms(torch, run, 20),
                           plain_ms=graph_time_ms(torch, plain, 5),
                           library_ms=graph_time_ms(torch, library, 20),
                           eager_ms=time_ms(torch, run, 20),
                           library_eager_ms=time_ms(torch, library, 20),
                           bound_ms=b_ms, bound_by=b_by, shape=[B, H, L, Dh])
        results[name] = rec

    # segmentation at B=32 x 1000 frames x 768: pass 1, then pass 2 +
    # compaction on pass 1's buffers
    seg = ops.segment
    B, L, d = 32, 1000, 768
    states = torch.from_numpy(synthetic_states(np.random.RandomState(0), B, L, d)).to(dev)
    norms = seg.frame_norms(states)
    voiced = norms >= 2.6
    voiced[3, 700:] = False
    plain = lambda: seg.segment_pass1_plain(states, voiced, 0.8)  # noqa: E731
    want = plain()
    run = lambda: seg.segment_pass1(states, voiced, 0.8)  # noqa: E731
    mism = sum(int((a.int() != b.int()).sum().item()) for a, b in zip(run(), want))
    nbytes = 4 * B * L * d + B * L * (1 + 1 + 1 + 4) + 2 * 8 * B * (L + 1) + 3 * 4 * B
    b_ms, b_by = bound_ms(nbytes, 9.0 * B * L * d, "float32")
    results["segment_pass1"] = {"float32": dict(
        max_abs_err=float(mism), tol=0, ok=mism == 0, ms=graph_time_ms(torch, run, 10),
        plain_ms=time_ms(torch, plain, 1, warmup=0), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, shape=[B, L, d],
        eager_ms=time_ms(torch, run, 10),
        chain_bound_ms=L * PASS1_CHAIN_CYCLES / sm_clock_hz() * 1e3)}

    P = seg._prefix_sums(states)
    p1 = seg.segment_pass1(states, voiced, 0.8)  # equal to the plain version's, see above
    args = (states, norms, P, p1.segs, p1.nseg, p1.mids, p1.nmid, 0.8)
    run = lambda: seg.segment_pass2(*args)  # noqa: E731
    plain = lambda: seg.segment_pass2_plain(*args)  # noqa: E731
    (got_segs, got_n), (want_segs, want_n) = run(), plain()
    mism = int((got_segs != want_segs).sum().item() + (got_n != want_n).sum().item())
    p_rows, win_frames = pass2_traffic(*(a.cpu().numpy() for a in args[:1] + args[3:7]), 0.8)
    nbytes = (4 * d * (p_rows + win_frames) + 4 * win_frames       # rows of P and states, norms
              + 2 * 8 * B * (L + 1) + 2 * 4 * B                   # segs, mids, nseg, nmid
              + 8 * B * (L + 1) + 4 * B)                          # segments, counts
    b_ms, b_by = bound_ms(nbytes, 2.5 * d * p_rows + 4.0 * d * win_frames, "float32")
    results["segment_pass2"] = {"float32": dict(
        max_abs_err=float(mism), tol=0, ok=mism == 0, ms=graph_time_ms(torch, run, 5),
        eager_ms=time_ms(torch, run, 10),
        plain_ms=time_ms(torch, plain, 1, warmup=0), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, shape=[B, L, d],
        mid_boundaries=int(p1.nmid.sum().item()), segments=int(got_n.sum().item()),
        p_rows_read=p_rows, window_frames=win_frames)}
    return results


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def pass2_traffic(states, segs, nseg, mids, nmid, thr):
    """What pass 2 must read for this data: the rows of the prefix sums (4 per
    mid boundary it looks at) and the window frames of its sweeps, counted by
    walking the refinement on the host in numpy as the oracle of the JAX
    package walks it."""
    def cos(x, y):
        return (x * y).sum(-1) / np.sqrt((x * x).sum(-1) + 1e-8) / np.sqrt((y * y).sum(-1) + 1e-8)

    p_rows = win_frames = 0
    for b in range(len(states)):
        row = [list(sg) for sg in segs[b, :nseg[b]]]
        for bd, gi in mids[b, :nmid[b]]:
            if gi >= len(row) - 1:
                continue
            (a0, a1), (b0, b1) = row[gi], row[gi + 1]
            p_rows += 4
            mean_a = states[b, a0:a1].mean(0) if a1 > a0 else np.zeros_like(states[b, 0])
            mean_b = states[b, b0:b1].mean(0)
            if cos(mean_a, mean_b) >= thr:
                row[gi + 1] = [a0, b1]
                continue
            ws = max(a0, bd - max(1, (a1 - a0) // 2))
            we = min(b1, bd + max(1, (b1 - b0) // 2))
            win_frames += we - ws
            prev, nxt = cos(states[b, ws:we], mean_a), cos(states[b, ws:we], mean_b)
            opt = ws + int(np.argmax([prev[:j].sum() + nxt[j:].sum() for j in range(we - ws)]))
            row[gi], row[gi + 1] = [a0, opt], [opt, b1]
    return int(p_rows), int(win_frames)


def segment_batch_plain(torch, seg, states, norm_threshold, merge_threshold, frame_valid=None):
    """``ops.segment.segment_batch`` with the plain version of each kernel."""
    norms = seg.frame_norms(states)
    voiced = norms >= norm_threshold
    if frame_valid is not None:
        voiced = voiced & frame_valid
    P = seg._prefix_sums(states)
    p1 = seg.segment_pass1_plain(states, voiced, merge_threshold)
    segs, n = seg.segment_pass2_plain(states, norms, P, p1.segs, p1.nseg, p1.mids, p1.nmid,
                                      merge_threshold)
    valid = torch.arange(segs.shape[1], device=n.device)[None, :] < n[:, None]
    feats = torch.where(valid[..., None], seg._segment_means(P, segs), 0.0)
    return seg.SegmentResult(segs, n, feats, norms)


def check_conv0_edges(torch, ops):
    """conv0 against its plain version on a DC offset, a batch with an all-zero
    item, and the 20 s bucket; correctness only (fp32 2e-4, bf16 2e-2)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    D = 512
    w = randn(D, 1, 10) / 10 ** 0.5
    gamma, beta = 1 + 0.1 * randn(D), 0.1 * randn(D)
    inputs = {"dc_offset_0.5": randn(8, 80000) + 0.5, "all_zero_item": randn(8, 80000),
              "bucket_20s": randn(8, 320000)}
    inputs["all_zero_item"][2] = 0.0
    inputs["bucket_20s"][1, 200000:] = 0.0
    records = []
    for name, x in inputs.items():
        for dt, tol in (("float32", 2e-4), ("bfloat16", 2e-2)):
            tdt = getattr(torch, dt)
            got = ops.frontend.conv0_gn_gelu(x, w, gamma, beta, out_dtype=tdt).float()
            want = ops.frontend.conv0_gn_gelu_plain(x, w, gamma, beta, out_dtype=tdt).float()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(got).all() and torch.allclose(got, want, rtol=tol, atol=tol))
            records.append(dict(input=name, shape=list(x.shape), dtype=dt, tol=tol, ok=ok,
                                max_abs_err=(got - want).abs().max().item()))
            del got, want
    return records


def check_segmentation_edges(torch, ops):
    """``segment_batch`` on the card (both kernels) against the same pipeline
    made of the plain versions, on the same tensors: segments and counts
    exactly, features to 1e-5. Also counts the launches of each call, which
    must not depend on the number of segments (two cases share a shape: one
    of ordinary rows, one with an unvoiced row and a row that closes a segment
    at every frame)."""
    seg = ops.segment
    dev = torch.device("cuda")
    rng = np.random.RandomState(11)

    def rows(B, L, d):
        return synthetic_states(rng, B, L, d)

    mixed = rows(4, 249, 768)
    mixed[1] = 0.0                                              # no voiced frame
    mixed[2] = rng.randn(249, 768).astype(np.float32) * 0.2     # a boundary at every frame
    valid = np.ones((4, 249), bool)
    valid[3, 100:] = False                                      # padded frames
    cases = [("L1", rows(2, 1, 768), None), ("L249_rows", mixed, valid),
             ("L249_plateaus", rows(4, 249, 768), valid),
             ("L4000", rows(2, 4000, 768), None), ("d144", rows(4, 300, 144), None),
             ("d1024", rows(2, 300, 1024), None), ("d50", rows(3, 300, 50), None)]
    records = []
    for name, states, frame_valid in cases:
        x = torch.from_numpy(states).to(dev)
        if frame_valid is None:  # every case takes the same ops: the launches compare
            frame_valid = np.ones(states.shape[:2], bool)
        fv = torch.from_numpy(frame_valid).to(dev)
        got, launches = count_launches(torch, lambda: seg.segment_batch(x, 2.6, 0.8, fv))
        want = segment_batch_plain(torch, seg, x, 2.6, 0.8, fv)
        torch.cuda.synchronize()
        mism = int((got.segments != want.segments).sum().item()
                   + (got.num_segments != want.num_segments).sum().item())
        err = (got.features - want.features).abs().max().item()
        records.append(dict(case=name, shape=list(states.shape), mismatches=mism,
                            feature_err=err, ok=mism == 0 and err <= 1e-5, launches=launches,
                            segments=got.num_segments.tolist()))
    return records


def check_pass1_ties(torch, ops):
    """Pass 1 where the cosine of two frames lies on the merge threshold or one
    ulp below it: the kernel's estimate of the cosine cannot decide there and
    the IEEE quotient must. Frames of small integers, so every sum is exact in
    any order and the kernel and its plain version see the same cosine."""
    seg = ops.segment
    dev = torch.device("cuda")
    records = []
    for second in ((1, 2), (1, 4), (2, 3), (3, 1)):
        states = np.zeros((1, 6, 768), np.float32)
        states[0, :, :2] = [(1, 1), second] * 3
        x = torch.from_numpy(states).to(dev)
        voiced = torch.ones(1, 6, dtype=torch.bool, device=dev)
        eps = np.float32(1e-8)
        cosine = (np.float32(second[0] + second[1]) / np.sqrt(np.float32(2) + eps)
                  / np.sqrt(np.float32(second[0] ** 2 + second[1] ** 2) + eps))
        for thr in (cosine, np.nextafter(cosine, np.float32(2))):
            got = seg.segment_pass1(x, voiced, float(thr))
            want = seg.segment_pass1_plain(x, voiced, float(thr))
            mism = sum(int((a.int() != b.int()).sum().item()) for a, b in zip(got, want))
            records.append(dict(second=list(second), thr=float(thr), mismatches=mism,
                                boundary=bool(want.boundary[0, 1].item()), ok=mism == 0))
    return records


def check_shared_divisor(torch, kernels, max_count):
    """The division that pass 1 forms its merged mean with (``Divisor`` of
    ``common.cuh``: a reciprocal taken once, then estimate, remainder and
    correction) against the IEEE division, computed on the host by numpy, bit
    for bit: the reciprocal of every frame count 1..``max_count`` must be the
    rounded ``1 / c`` (with that the quotient is the rounded one for every
    numerator in range, by Markstein's theorem), and the quotients of random
    numerators over 2^-40..2^27 in size, by every count once and by counts
    up to 4001 seven times as often, must have the bits of ``x / c``."""
    rng = np.random.RandomState(4)
    c = np.concatenate([np.arange(1, max_count + 1),
                        rng.randint(1, 4002, 7 * max_count)]).astype(np.float32)
    x = (rng.randn(c.size) * np.exp(rng.uniform(-12, 8, c.size))).astype(np.float32)
    dev = torch.device("cuda")
    tx, tc = torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)
    q, r = torch.empty_like(tx), torch.empty_like(tx)
    kernels.check(kernels.lib().sylber_shared_divisor(
        tx.data_ptr(), tc.data_ptr(), q.data_ptr(), r.data_ptr(), c.size,
        kernels.stream_of(tx)), "shared_divisor")
    torch.cuda.synchronize()
    bad_r = int((r.cpu().numpy().view(np.int32) != (np.float32(1) / c).view(np.int32)).sum())
    bad_q = int((q.cpu().numpy().view(np.int32) != (x / c).view(np.int32)).sum())
    return dict(divisors=max_count, quotients=int(c.size), reciprocal_mismatches=bad_r,
                quotient_mismatches=bad_q, ok=bad_r == 0 and bad_q == 0)


def count_launches(torch, fn):
    """``fn()`` and the number of device kernels and copies it enqueued."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


def check_attention_edges(torch, ops):
    """Both attention kernels against their plain versions where tiles, head
    widths and key lengths are awkward; correctness only. Returns one record
    per call; ``ok`` is False where the tolerance (fp32 2e-5, bf16 2e-2) is
    missed or a value is not finite."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    small = (ops.smallattn.small_attention, ops.smallattn.small_attention_plain)
    flash = (ops.flash.flash_attention, ops.flash.flash_attention_plain)
    cases = []  # (name, (kernel, plain), L, D, scale, strided)
    for L in (1, 77, 512):
        cases += [("small_attention", small, L, D, None, D == 64) for D in (12, 32, 64, 128)]
    for L in (513, 1999):
        cases += [("flash_attention", flash, L, D, 0.3 if D != 32 else None, strided)
                  for D, strided in ((12, False), (32, True), (64, False), (64, True),
                                     (128, True))]
    records = []
    for name, (fn, plain_fn), L, D, scale, strided in cases:
        # nothing valid, one key, around a 64-key tile edge, one short of L, L
        lens = sorted({0, 1, min(63, L), min(64, L), min(65, L), L - 1, L})
        B, H = len(lens), 3
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            tdt = getattr(torch, dt)
            if strided:  # (B, H, L, D) views of (B, L, H, D) memory
                q, k, v = (torch.randn(B, L, H, D, device=dev, generator=gen).to(tdt)
                           .transpose(1, 2) for _ in range(3))
            else:
                q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).to(tdt)
                           for _ in range(3))
            got, want = fn(q, k, v, kv_len, scale), plain_fn(q, k, v, kv_len, scale)
            torch.cuda.synchronize()
            got, want = got.float(), want.float()
            ok = bool(torch.isfinite(got).all()
                      and torch.allclose(got, want, rtol=tol, atol=tol))
            records.append(dict(kernel=name, L=L, D=D, dtype=dt, kv_len=lens, scale=scale,
                                strided=strided, tol=tol, ok=ok,
                                max_abs_err=(got - want).abs().max().item()))
    return records


# ---------------------------------------------------------------- phase 3

def profile(torch, fn, top: int = 12):
    """Device time by kernel over one call of ``fn`` (torch.profiler), with the
    wall time of the profiled call; the profiler itself slows the host."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = {k[:70]: v for k, v in ranked
            if any(tag in k for tag in ("sylber", "conv0_", "segment_pass"))}
    return dict(wall_ms=wall * 1e3, device_ms=sum(by_name.values()),
                launches=len(kernels), top_ms=[(k[:60], v) for k, v in ranked[:top]],
                port_kernels_ms=ours)


def check_outputs(outs, wavs, cfg, width):
    for out, w in zip(outs, wavs):
        t = cfg.feat_extract_output_length(len(w))
        h, seg, feats = out["hidden_states"], out["segments"], out["segment_features"]
        assert h.shape == (t, width) and np.isfinite(h).all(), h.shape
        assert np.isfinite(out["frame_norms"]).all() and out["frame_norms"].shape == (t,)
        if len(seg):
            assert feats.shape == (len(seg), width) and np.isfinite(feats).all()
            assert (seg[:, 0] < seg[:, 1]).all() and seg.min() >= 0 and seg.max() <= t
            assert (seg[1:, 0] >= seg[:-1, 1]).all()


def forbid_host_syncs(torch, fn):
    """``fn`` with ``torch.cuda.set_sync_debug_mode("error")`` around each call:
    an operation inside it that waits for the device raises."""
    def guarded(*args, **kwargs):
        saved = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(saved)
    return guarded


def main_path(torch, Segmenter, HubertConfig, counters):
    rng = np.random.RandomState(1)
    batches = {
        "small_32x5s": [speechlike(rng, 5 * 16000) for _ in range(32)],
        "flash_32x12-20s": [speechlike(rng, int(rng.uniform(12, 20) * 16000))
                            for _ in range(32)],
    }
    modes = {
        "fp32_highest": HubertConfig(),
        "bf16_default": HubertConfig(dtype="bfloat16", frontend_dtype="bfloat16",
                                     precision="default"),
    }
    runs, hidden = [], {}
    for fn in counters:
        fn.launches = 0
    for mode, cfg in modes.items():
        seg = Segmenter(hubert_config=cfg)
        for bname, wavs in batches.items():
            seg.process(wavs, in_second=False)  # warm-up: cuDNN plans, kernel build
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                outs = seg.process(wavs, in_second=False)
                walls.append(time.perf_counter() - t0)
            check_outputs(outs, wavs, cfg, 768)
            audio_s = sum(len(w) for w in wavs) / 16000.0
            rtfx = sorted(audio_s / w for w in walls)
            hidden[(mode, bname)] = outs[0]["hidden_states"]
            runs.append(dict(mode=mode, batch=bname, audio_s=audio_s, wall_s=walls,
                             rtfx=rtfx[2], rtfx_min=rtfx[0], rtfx_max=rtfx[-1],
                             segments=int(sum(len(o["segments"]) for o in outs)),
                             profile=profile(torch, lambda: seg.process(wavs))))
            prof = runs[-1]["profile"]
            log(f"main path {mode} {bname}: {audio_s:.1f} s audio, 5 timed calls: RTFx median "
                f"{rtfx[2]:.1f} (min {rtfx[0]:.1f}, max {rtfx[-1]:.1f}), "
                f"{runs[-1]['segments']} segments; "
                f"profiled run: device busy {prof['device_ms']:.1f} of "
                f"{prof['wall_ms']:.1f} ms, {prof['launches']} launches; top: "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["top_ms"][:6])
                + "; the port's kernels: "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in prof["port_kernels_ms"].items()))
            if prof["launches"] >= 1000:
                raise AssertionError(f"{mode} {bname}: {prof['launches']} launches in one "
                                     "process() call; the segmentation should add a fixed few")
        del seg
        torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches for fn in counters}
    for bname in batches:
        a, b = hidden[("fp32_highest", bname)], hidden[("bf16_default", bname)]
        log(f"bf16 vs fp32 hidden, {bname}: max abs diff {np.abs(a - b).max():.4g}")
    return runs, launches


# ---------------------------------------------------------------- phase 4

def mini_ckpt_agreement(torch, Segmenter, HubertConfig):
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    cfg = HubertConfig(num_hidden_layers=meta["encoding_layer"], **hub)
    kw = dict(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), hubert_config=cfg,
              norm_threshold=meta["norm_threshold"], merge_threshold=meta["merge_threshold"])
    gpu, cpu = Segmenter(device="cuda", **kw), Segmenter(device="cpu", **kw)
    rng = np.random.RandomState(2)
    wavs = [speechlike(rng, int(s * 16000)) for s in (3.0, 7.5, 12.0)]  # 12 s: flash path
    report = []
    for name, call in (("speechlike.wav", dict(wav_file=str(FIXTURES / "speechlike.wav"))),
                       ("3 utterances, 3-12 s", dict(wav=wavs))):
        g, c = gpu(in_second=False, **call), cpu(in_second=False, **call)
        g, c = (g, c) if isinstance(g, list) else ([g], [c])
        same = all(a["segments"].tolist() == b["segments"].tolist() for a, b in zip(g, c))
        diff = max(np.abs(a["hidden_states"] - b["hidden_states"]).max() for a, b in zip(g, c))
        nseg = [len(a["segments"]) for a in g]
        log(f"mini_ckpt {name}: segments identical {same} {nseg}, "
            f"max |hidden gpu - cpu| {diff:.3g}")
        report.append(dict(input=name, identical=same, segments=nseg,
                           max_hidden_diff=float(diff)))
        if not same:
            raise AssertionError(f"mini_ckpt segments differ between GPU and CPU on {name}")

    # bf16 fast mode against fp32 parity mode, both on the card: 16 held-out
    # utterances of 3-8 s (small-attention path) and two of 11-14 s (flash)
    from sylber_tpu_torch.utils.metrics import boundary_f1

    fast_cfg = HubertConfig(num_hidden_layers=meta["encoding_layer"], dtype="bfloat16",
                            frontend_dtype="bfloat16", precision="default", **hub)
    fast = Segmenter(device="cuda", **{**kw, "hubert_config": fast_cfg})
    rng = np.random.RandomState(9999)
    held = [speechlike(rng, int(rng.uniform(3.0, 8.0) * 16000)) for _ in range(16)]
    held += [speechlike(rng, int(s * 16000)) for s in (11.0, 14.0)]
    exact_out = gpu.process(held, in_second=False, return_hidden=False)
    fast_out = fast.process(held, in_second=False, return_hidden=False)
    f1 = float(np.mean([boundary_f1(f["segments"], e["segments"], tol_frames=0)
                        for f, e in zip(fast_out, exact_out)]))
    nseg = int(sum(len(e["segments"]) for e in exact_out))
    log(f"mini_ckpt bf16 fast vs fp32 exact on the card: boundary F1 (tol 0) {f1:.5f} "
        f"over {len(held)} utterances, {nseg} segments")
    report.append(dict(input="bf16 vs fp32, 18 utterances", boundary_f1_tol0=f1,
                       segments=nseg))
    if f1 < 0.995 or nseg == 0:
        raise AssertionError(f"bf16 fast mode boundary F1 {f1} < 0.995 against fp32")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON to this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sylber_tpu_torch import Segmenter, kernels, ops
    from sylber_tpu_torch.models.hubert import HubertConfig, matmul_precision

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s -> {so.name}")

    with matmul_precision("highest"):
        checks = check_kernels(torch, ops)
    for name, rec in checks.items():
        for dt, r in rec.items():
            log(f"phase 2: {name} {dt} {r['shape']}: max_abs_err {r['max_abs_err']:.3g} "
                f"(tol {r['tol']}) ok={r['ok']}  kernel_ms {r['ms']:.4f}  "
                f"plain_ms {r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})  [{smi}]")
    p1, p2 = checks["segment_pass1"]["float32"], checks["segment_pass2"]["float32"]
    log(f"phase 2: segment_pass1 eager {p1['eager_ms']:.4f} ms; chain bound "
        f"{p1['chain_bound_ms']:.4f} ms  [{smi}]")
    log(f"phase 2: segment_pass2 looked at {p2['mid_boundaries']} mid boundaries, read "
        f"{p2['p_rows_read']} rows of prefix sums and {p2['window_frames']} window frames, "
        f"left {p2['segments']} segments")
    bad = [f"{n} {dt}" for n, rec in checks.items() for dt, r in rec.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    with matmul_precision("highest"):
        edges = check_attention_edges(torch, ops)
        conv0_edges = check_conv0_edges(torch, ops)
        seg_edges = check_segmentation_edges(torch, ops)
        ties = check_pass1_ties(torch, ops)
    division = check_shared_divisor(torch, kernels, ops.segment.MAX_FRAMES)
    for name in ("small_attention", "flash_attention"):
        for dt in ("float32", "bfloat16"):
            errs = [e["max_abs_err"] for e in edges if e["kernel"] == name and e["dtype"] == dt]
            log(f"phase 2: {name} {dt} edge shapes: {len(errs)} calls, "
                f"worst max_abs_err {max(errs):.3g}")
    for e in conv0_edges:
        log(f"phase 2: conv0_gn_gelu {e['dtype']} {e['input']} {e['shape']}: max_abs_err "
            f"{e['max_abs_err']:.3g} (tol {e['tol']}) ok={e['ok']}")
    for e in seg_edges:
        log(f"phase 2: segment_batch {e['case']} {e['shape']}: {e['mismatches']} mismatches, "
            f"feature err {e['feature_err']:.3g}, {e['launches']} launches, segments "
            f"{e['segments']} ok={e['ok']}")
    log(f"phase 2: segment_pass1 with a cosine on the threshold and one ulp below it: "
        f"{len(ties)} calls, {sum(t['mismatches'] for t in ties)} mismatches, boundaries "
        f"{[t['boundary'] for t in ties]}")
    log(f"phase 2: pass 1's shared-divisor division against IEEE x / c: frame counts 1.."
        f"{division['divisors']}, {division['reciprocal_mismatches']} reciprocals and "
        f"{division['quotient_mismatches']} of {division['quotients']} quotients differ")
    bad = [e for e in edges + conv0_edges + seg_edges + ties + [division] if not e["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at edge shapes: {bad}")
    by_shape = {}
    for e in seg_edges:
        by_shape.setdefault(tuple(e["shape"]), set()).add(e["launches"])
    if any(len(v) != 1 for v in by_shape.values()):
        raise AssertionError("the launches of segment_batch depend on the segments found: "
                             f"{[(e['case'], e['launches']) for e in seg_edges]}")

    import sylber_tpu_torch.api as api

    counters = [ops.frontend.conv0_gn_gelu, ops.smallattn.small_attention,
                ops.flash.flash_attention, ops.segment.segment_pass1,
                ops.segment.segment_pass2]
    segment_batch = api.segment_batch
    api.segment_batch = forbid_host_syncs(torch, segment_batch)
    try:
        runs, launches = main_path(torch, Segmenter, HubertConfig, counters)
    finally:
        api.segment_batch = segment_batch
    log(f"phase 3: launches over the main path ({len(runs)} configurations x "
        f"warm-up, 5 timed and one profiled run): {launches}  [{smi}]")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    mini = mini_ckpt_agreement(torch, Segmenter, HubertConfig)

    sources = {"conv0_gn_gelu": ("frontend.cu", "sylber_tpu/ops/pallas/frontend.py:122"),
               "small_attention": ("smallattn.cu", "sylber_tpu/ops/pallas/smallattn.py:78"),
               "flash_attention": ("flash.cu", "sylber_tpu/ops/pallas/flash.py:125"),
               "segment_pass1": ("segment_scan.cu", "sylber_tpu/ops/segment.py:49"),
               "segment_pass2": ("segment_scan.cu", "sylber_tpu/ops/segment.py:129")}
    line = []
    for name, rec in checks.items():
        r = rec["float32"]
        entry = dict(name=name, route="cuda",
                     source=f"sylber_tpu_torch/csrc/{sources[name][0]}",
                     replaces=sources[name][1], launches=launches[name],
                     max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"], dtype="float32", shape=r["shape"])
        extra = tuple(k for k in ("eager_ms", "library_eager_ms", "chain_bound_ms",
                                  "mid_boundaries", "p_rows_read", "window_frames") if k in r)
        entry.update({k: r[k] for k in extra})
        if "bfloat16" in rec:
            entry["bfloat16"] = {k: rec["bfloat16"][k] for k in
                                 ("max_abs_err", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by") + extra}
        line.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        build_log = kernels.BUILD_DIR / "build.log"  # registers, shared memory, spills
        if build_log.exists():
            Path(args.out).with_suffix(".build.log").write_text(build_log.read_text())
        Path(args.out).write_text(json.dumps(dict(card=smi, kernels=line, main_path=runs,
                                                  attention_edges=edges,
                                                  conv0_edges=conv0_edges,
                                                  segmentation_edges=seg_edges,
                                                  pass1_ties=ties,
                                                  shared_divisor=division,
                                                  mini_ckpt=mini),
                                             indent=1))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
