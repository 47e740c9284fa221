#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sylber_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the script when it fails:

1. build the CUDA kernels of ``sylber_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes and layout, fp32 and bf16, with ragged key lengths and
   a fully padded item (flash attention also at the long-form windows'
   shape, B8 L1549); time the kernel, the plain version and, as a
   yardstick only, one PyTorch library call computing the same function
   (all three on the same tensors); then hold the two
   attention kernels against their plain versions at the awkward shapes
   (sequence lengths off the tile, head widths 12 to 128, key lengths at the
   tile edges, a scale override, contiguous and strided ``(B, L, H, D)`` views),
   conv0 on a DC offset, an all-zero item and the 20 s bucket, the whole
   segmentation at awkward lengths, widths and rows, conv0, small attention
   and the segmentation at the consumers' shapes (a long-form window batch
   of 8 x 496,000 samples, L 1549; a streaming hop of 64,000, L 199), and
   the division of pass 1's merged mean against the IEEE division for
   every frame count;
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
   0 must reach 0.995; then long-form (40 s, both transfers), streaming
   (30 s) and the tokenizer (``mini_codebook_1024.npy``) on the card and on
   the CPU: segments, commits and tokens identical, and the int16 long-form
   path against the float32 one at F1 >= 0.995;
5. the Segmenter's consumers at full width, seeded random weights, bf16 fast
   mode: long-form over a 10-minute recording (22 windows of 30 s; real-time
   factor of 3 calls, an fp32 call, the float32-window and return_hidden
   paths; its window dispatch and segment_batch under
   ``set_sync_debug_mode("error")``; under 1,000 launches a window batch),
   streaming (60 s in 0.05-0.4 s pushes; wall time a hop), the tokenizer
   (a seeded 10,000-unit codebook, card against CPU), the server
   (``scripts/serving_probe.py``'s traffic at pipeline depth 0 and 1;
   latency percentiles, throughput, a lone request against ``process``,
   the speculative copy, whose event must be what orders the reads) and
   the HTTP shim
   (``python -m sylber_tpu_torch.serve_http``); each run counts the kernel
   launches, which the ``{"kernels": [...]}`` line adds to phase 3's;
6. distillation training (``sylber_tpu_torch.train.loop.train``) at full
   width on the synthetic corpus, stage 2 as ``configs/sylber_base_stage2_tpu.yaml``
   sets it (online segmentation, ``use_train_thrupdate``, noise mixing, int16
   transfer): the kernels against their plain versions at the trainer's
   shapes (conv0 at 100 x 80,320, small attention at B100 H12 L250 D64,
   ``segment_batch`` at B100 L250 d768 with a device-tensor norm threshold);
   a bf16 / default run at B100 x 5 s and an fp32 / highest run (batch
   ``FP32_BATCH``), 3 warm-up and 10 timed steps each, with every launch
   counter from 0 (conv0, small attention and both segmentation passes must
   launch), step time, audio seconds a second, MFU, peak memory, one step
   under ``set_sync_debug_mode("error")``, a profiled step and the step in
   parts; one stage-2 step of ``mini_ckpt.npz`` on the card against the CPU;
   a run resumed from its step-3 checkpoint against an uninterrupted one;
   and ``remat`` against no remat with dropout on;
7. the resynthesis chain (``SegmentSynthesis`` -> ``SparcDecoder``): both
   attention kernels at the voicebox regressor's shapes and softmax scale
   of 10 (small at B8 H8 L265 D64, flash at B1 H8 L1015 D64) against their
   plain versions, with SDPA timed; then at full width on seeded random
   weights (``configs/sylber_resynthesis.yaml``, ``SparcDecoderConfig()``)
   ``resynthesize`` + ``decode_audio`` on 8 x 5 s and 1 x 20 s, midpoint
   with 5 steps at ``cond_scale`` 1 and 1.5, fp32 under "highest" and
   "default" precision: the wav -> wav real-time factor of five calls, the
   milliseconds of encoder + segmentation, conditioning, sampler and
   vocoder, the sampler's launches (and no host sync in it, under
   ``set_sync_debug_mode("error")``), device busy and peak memory; every
   launch counter from 0 and each kernel must launch; then the trained
   mini fixtures on the card against the CPU (``mini_synth`` wav and
   feature paths, midpoint and tsit5; the explicit-pitch
   ``mini_synth_rich_pitch``; the token path of ``mini_vq_synth`` +
   ``mini_vq_tokenizer``; ``mini_vocoder``'s waveform and its log-mel).
   ``--only-resynthesis`` runs phases 1 and 7 alone and prints no result.

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
import tempfile
import threading
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
# phase 2's record of flash attention at the long-form windows' shape
LONGFORM_FLASH = "flash_attention_B8_L1549"
# phase 6's fp32 training run: the batch, and whether the encoder layers are
# recomputed in the backward pass
FP32_BATCH, FP32_REMAT = 100, False


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

def conv0_record(torch, ops, x, w, gamma, beta):
    """conv0 + GroupNorm + GELU on ``x`` (B, L) in both output dtypes: the
    kernel against its plain version, times and bound."""
    F = torch.nn.functional
    (B, L), D = x.shape, w.shape[0]
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
        del got, want
        b_ms, b_by = bound_ms(nbytes, B * T0 * D * (2 * 10 + 4), "float32")
        rec[dt] = dict(max_abs_err=err, tol=tol, ok=bool(ok),
                       ms=graph_time_ms(torch, run, 5), plain_ms=time_ms(torch, plain, 5),
                       library_ms=time_ms(torch, library, 5), eager_ms=time_ms(torch, run, 10),
                       bound_ms=b_ms, bound_by=b_by, shape=[B, L, D])
        torch.cuda.empty_cache()
    return rec


def attention_record(torch, fn, plain_fn, B, L, gen, small: bool):
    """One attention kernel at (B, H12, L, D64) in both dtypes, on (B, H, L, D)
    views of (B, L, H, D) memory with ragged key lengths, a full item and a
    fully padded one: against its plain version, times, bound and SDPA."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    H, Dh = 12, 64
    lens = torch.randint(L // 2, L + 1, (B,), device=dev, generator=gen).to(torch.int32)
    lens[0], lens[1] = L, 0
    keep = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    rec = {}
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        tdt = getattr(torch, dt)
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
        if small:
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
        del got, want, q, k, v
    return rec


def segmentation_records(torch, seg, states, voiced, norms, thr=0.8):
    """Pass 1 and pass 2 + compaction on ``states``: events and segments
    against the plain versions (0 mismatches), times and bounds."""
    B, L, d = states.shape
    plain = lambda: seg.segment_pass1_plain(states, voiced, thr)  # noqa: E731
    want = plain()
    run = lambda: seg.segment_pass1(states, voiced, thr)  # noqa: E731
    mism = sum(int((a.int() != b.int()).sum().item()) for a, b in zip(run(), want))
    nbytes = 4 * B * L * d + B * L * (1 + 1 + 1 + 4) + 2 * 8 * B * (L + 1) + 3 * 4 * B
    b_ms, b_by = bound_ms(nbytes, 9.0 * B * L * d, "float32")
    p1 = {"float32": dict(
        max_abs_err=float(mism), tol=0, ok=mism == 0, ms=graph_time_ms(torch, run, 10),
        plain_ms=time_ms(torch, plain, 1, warmup=0), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, shape=[B, L, d],
        eager_ms=time_ms(torch, run, 10),
        chain_bound_ms=L * PASS1_CHAIN_CYCLES / sm_clock_hz() * 1e3)}

    P = seg._prefix_sums(states)
    p1e = seg.segment_pass1(states, voiced, thr)  # equal to the plain version's, see above
    args = (states, norms, P, p1e.segs, p1e.nseg, p1e.mids, p1e.nmid, thr)
    run = lambda: seg.segment_pass2(*args)  # noqa: E731
    plain = lambda: seg.segment_pass2_plain(*args)  # noqa: E731
    (got_segs, got_n), (want_segs, want_n) = run(), plain()
    mism = int((got_segs != want_segs).sum().item() + (got_n != want_n).sum().item())
    p_rows, win_frames = pass2_traffic(*(a.cpu().numpy() for a in args[:1] + args[3:7]), thr)
    nbytes = (4 * d * (p_rows + win_frames) + 4 * win_frames       # rows of P and states, norms
              + 2 * 8 * B * (L + 1) + 2 * 4 * B                   # segs, mids, nseg, nmid
              + 8 * B * (L + 1) + 4 * B)                          # segments, counts
    b_ms, b_by = bound_ms(nbytes, 2.5 * d * p_rows + 4.0 * d * win_frames, "float32")
    p2 = {"float32": dict(
        max_abs_err=float(mism), tol=0, ok=mism == 0, ms=graph_time_ms(torch, run, 5),
        eager_ms=time_ms(torch, run, 10),
        plain_ms=time_ms(torch, plain, 1, warmup=0), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, shape=[B, L, d],
        mid_boundaries=int(p1e.nmid.sum().item()), segments=int(got_n.sum().item()),
        p_rows_read=p_rows, window_frames=win_frames)}
    return p1, p2


def check_kernels(torch, ops):
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
    results["conv0_gn_gelu"] = conv0_record(torch, ops, x, w, gamma, beta)

    # attention: small path at L=250, flash path at L=1000, and flash at the
    # long-form windows' shape (8 windows of 31 s, L=1549, not a multiple of
    # the 64-key tile)
    for name, B, L, fn, plain_fn in (
            ("small_attention", 32, 250, ops.smallattn.small_attention,
             ops.smallattn.small_attention_plain),
            ("flash_attention", 32, 1000, ops.flash.flash_attention,
             ops.flash.flash_attention_plain),
            (LONGFORM_FLASH, 8, 1549, ops.flash.flash_attention,
             ops.flash.flash_attention_plain)):
        results[name] = attention_record(torch, fn, plain_fn, B, L, gen,
                                         small=name == "small_attention")

    # segmentation at B=32 x 1000 frames x 768: pass 1, then pass 2 +
    # compaction on pass 1's buffers
    seg = ops.segment
    B, L, d = 32, 1000, 768
    states = torch.from_numpy(synthetic_states(np.random.RandomState(0), B, L, d)).to(dev)
    norms = seg.frame_norms(states)
    voiced = norms >= 2.6
    voiced[3, 700:] = False
    results["segment_pass1"], results["segment_pass2"] = segmentation_records(
        torch, seg, states, voiced, norms)
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
    item, the 20 s bucket, and the consumers' shapes: long-form's window
    batch (8 x 496,000 samples, a short last window zeroed past its end)
    and a streaming hop (1 x 64,000); correctness only (fp32 2e-4, bf16
    2e-2)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    D = 512
    w = randn(D, 1, 10) / 10 ** 0.5
    gamma, beta = 1 + 0.1 * randn(D), 0.1 * randn(D)
    inputs = {"dc_offset_0.5": randn(8, 80000) + 0.5, "all_zero_item": randn(8, 80000),
              "bucket_20s": randn(8, 320000), "longform_window_batch": randn(8, 496000),
              "streaming_hop": randn(1, 64000)}
    inputs["all_zero_item"][2] = 0.0
    inputs["bucket_20s"][1, 200000:] = 0.0
    inputs["longform_window_batch"][7, 120000:] = 0.0
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
    at every frame). The last two cases are the consumers' shapes: a
    long-form window batch (B8 L1549, a short last window) and a streaming
    hop (B1 L199)."""
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
    longform_valid = np.ones((8, 1549), bool)
    longform_valid[7, 374:] = False
    cases += [("longform_B8_L1549", rows(8, 1549, 768), longform_valid),
              ("streaming_B1_L199", rows(1, 199, 768), None)]
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


def count_launches(torch, fn, tries: int = 3):
    """``fn()`` and the number of device kernels and copies it enqueued: the
    most that any of ``tries`` profiled calls saw. The profiler can lose a
    call's device events (the same call has read 18, 19, 26 and 27 across
    runs) and never adds one, so the largest count is the call's."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return out, max(counts)


def check_attention_edges(torch, ops):
    """Both attention kernels against their plain versions where tiles, head
    widths and key lengths are awkward; correctness only. Returns one record
    per call; ``ok`` is False where the tolerance (fp32 2e-5, bf16 2e-2) is
    missed or a value is not finite. The last case is a streaming hop's
    shape, B1 H12 L199 D64, every key valid."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    small = (ops.smallattn.small_attention, ops.smallattn.small_attention_plain)
    flash = (ops.flash.flash_attention, ops.flash.flash_attention_plain)
    cases = []  # (name, (kernel, plain), L, D, scale, strided, heads, kv_len)
    for L in (1, 77, 512):
        cases += [("small_attention", small, L, D, None, D == 64, 3, None)
                  for D in (12, 32, 64, 128)]
    for L in (513, 1999):
        cases += [("flash_attention", flash, L, D, 0.3 if D != 32 else None, strided, 3, None)
                  for D, strided in ((12, False), (32, True), (64, False), (64, True),
                                     (128, True))]
    cases.append(("small_attention", small, 199, 64, None, True, 12, [199]))
    records = []
    for name, (fn, plain_fn), L, D, scale, strided, H, lens in cases:
        # nothing valid, one key, around a 64-key tile edge, one short of L, L
        lens = lens or sorted({0, 1, min(63, L), min(64, L), min(65, L), L - 1, L})
        B = len(lens)
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
            records.append(dict(kernel=name, shape=[B, H, L, D], dtype=dt, kv_len=lens,
                                scale=scale, strided=strided, tol=tol, ok=ok,
                                max_abs_err=(got - want).abs().max().item()))
    return records


# ---------------------------------------------------------------- phase 3

def profile(torch, fn, top: int = 12):
    """Device time by kernel over one call of ``fn`` (torch.profiler), with the
    wall time of the profiled call; the profiler itself slows the host.

    ``device_ms`` is the time the device was busy: the union of the device
    events' intervals, so events that overlap (on other streams) count once.
    ``device_sum_ms`` is the plain sum of their durations, ``overlap_ms`` the
    difference, and ``duplicate_events`` the events that share a name and a
    start with another (events the profiler reported twice)."""
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
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = {k[:70]: v for k, v in ranked
            if any(tag in k for tag in ("sylber", "conv0_", "segment_pass"))}
    total = sum(by_name.values())
    return dict(wall_ms=wall * 1e3, device_ms=busy_us / 1e3, device_sum_ms=total,
                overlap_ms=total - busy_us / 1e3,
                duplicate_events=len(kernels) - len({(e.name, e.time_range.start)
                                                     for e in kernels}),
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
    return report + mini_consumers(gpu, cpu)


def stream_commits(StreamingSegmenter, seg, wav):
    """Push ``wav`` in 0.05-0.4 s chunks (rng seed 1) through a streaming
    segmenter (window 4 s, hop 1 s, guard 0.5 s); the committed frames."""
    stream = StreamingSegmenter(seg, window_seconds=4.0, hop_seconds=1.0,
                                commit_guard_seconds=0.5)
    rng = np.random.RandomState(1)
    committed, pos = [], 0
    while pos < len(wav):
        n = int(rng.uniform(0.05, 0.4) * 16000)
        committed.extend(stream.push(wav[pos: pos + n], in_second=False))
        pos += n
    committed += stream.flush(in_second=False)
    arr = np.asarray(committed, np.int64).reshape(-1, 2)
    if not (len(arr) and (arr[:, 1] > arr[:, 0]).all() and (arr[1:, 0] >= arr[:-1, 1]).all()
            and arr[-1, 1] <= len(wav) // 320):
        raise AssertionError("streaming commits are not exactly once and in order")
    return committed


def token_differences(got, want, feats, centroids, rtol=1e-6):
    """(ties, others) among the token ids that differ: a tie is an id whose
    two nearest centroids (float64 distances from ``feats``) are the two ids
    and lie within ``rtol`` relative of each other."""
    ties = others = 0
    x, c = feats.astype(np.float64), centroids.astype(np.float64)
    for i in np.nonzero(got != want)[0]:
        dist = ((x[i][None, :] - c) ** 2).sum(-1)
        two = np.argsort(dist)[:2]
        if ({int(got[i]), int(want[i])} == set(two.tolist())
                and dist[two[1]] - dist[two[0]] <= rtol * dist[two[1]]):
            ties += 1
        else:
            others += 1
    return ties, others


def mini_consumers(gpu, cpu):
    """Long-form (both transfers), streaming and the tokenizer on the trained
    mini checkpoint, on the card against the CPU."""
    from sylber_tpu_torch.longform import LongFormSegmenter
    from sylber_tpu_torch.streaming import StreamingSegmenter
    from sylber_tpu_torch.tokenizer import SylberTokenizer
    from sylber_tpu_torch.utils.metrics import boundary_f1

    report = []
    wav = speechlike(np.random.RandomState(40), 40 * 16000)
    on_card = {}
    for transfer in ("float32", "int16"):
        g, c = (LongFormSegmenter(s, chunk_seconds=10.0, overlap_seconds=2.0, transfer=transfer)(
            wav=wav, in_second=False, return_hidden=False) for s in (gpu, cpu))
        same = g["segments"].tolist() == c["segments"].tolist()
        err = float(np.abs(g["segment_features"] - c["segment_features"]).max()) if same else None
        log(f"mini_ckpt long-form 40 s, transfer={transfer}: segments identical card vs CPU "
            f"{same} ({len(g['segments'])}), max |feature diff| {err}")
        report.append(dict(input=f"long-form 40 s {transfer}", identical=same,
                           segments=len(g["segments"]), max_feature_diff=err))
        if not same or not len(g["segments"]):
            raise AssertionError(f"mini_ckpt long-form ({transfer}) differs between GPU and CPU")
        on_card[transfer] = g
    f1 = boundary_f1(on_card["int16"]["segments"], on_card["float32"]["segments"], tol_frames=0)
    log(f"mini_ckpt long-form int16 vs float32 on the card: boundary F1 (tol 0) {f1:.5f}")
    report.append(dict(input="long-form int16 vs float32 on the card", boundary_f1_tol0=f1))
    if f1 < 0.995:
        raise AssertionError(f"long-form int16 vs float32 boundary F1 {f1} < 0.995")

    wav = speechlike(np.random.RandomState(30), 30 * 16000)
    g, c = (stream_commits(StreamingSegmenter, s, wav) for s in (gpu, cpu))
    log(f"mini_ckpt streaming 30 s: {len(g)} commits, identical card vs CPU {g == c}")
    report.append(dict(input="streaming 30 s", identical=g == c, commits=len(g)))
    if g != c:
        raise AssertionError("mini_ckpt streaming commits differ between GPU and CPU")

    codebook = str(FIXTURES / "mini_codebook_1024.npy")
    wavs = [speechlike(np.random.RandomState(s), int(l * 16000)) for s, l in ((41, 3.5), (42, 6.0))]
    g, c = (SylberTokenizer(s, centroids=codebook)(wav=wavs, in_second=False) for s in (gpu, cpu))
    got, want = (np.concatenate([o["tokens"] for o in x]) for x in (g, c))
    same = got.shape == want.shape and bool((got == want).all())
    log(f"mini_ckpt tokenizer (mini_codebook_1024): {len(got)} tokens, identical card vs CPU "
        f"{same}")
    report.append(dict(input="tokenizer mini_codebook_1024", identical=same, tokens=len(got)))
    if not same:
        raise AssertionError("mini_ckpt tokens differ between GPU and CPU")
    return report


# ---------------------------------------------------------------- phase 5

def percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def consumers_full_width(torch, Segmenter, HubertConfig, counters, smi):
    """Long-form, streaming, the tokenizer, the server and the HTTP shim at
    full hubert-base width on seeded random weights, in bf16 fast mode (the
    serving configuration). Returns the report and the kernel launches of
    its runs (each counted with the counters set to 0 just before it)."""
    import sylber_tpu_torch.api as api
    from sylber_tpu_torch.longform import LongFormSegmenter
    from sylber_tpu_torch.quantizer import KMQuantizer
    from sylber_tpu_torch.serve import SegmenterServer
    from sylber_tpu_torch.streaming import StreamingSegmenter
    from sylber_tpu_torch.tokenizer import SylberTokenizer, encode
    from sylber_tpu_torch.utils.metrics import boundary_f1

    launches = {fn.__name__: 0 for fn in counters}

    def counted(label, fn):
        for c in counters:
            c.launches = 0
        out = fn()
        got = {c.__name__: c.launches for c in counters}
        for k, v in got.items():
            launches[k] += v
        log(f"phase 5 {label}: kernel launches {got}")
        return out, got

    report = {}
    fast = Segmenter(hubert_config=HubertConfig(dtype="bfloat16", frontend_dtype="bfloat16",
                                                precision="default"))

    # ---- long-form: 10 minutes, 30 s windows, 2 s overlap, 8 windows a batch
    wav = speechlike(np.random.RandomState(600), 600 * 16000)
    audio_s = len(wav) / 16000.0
    frames = fast.config.feat_extract_output_length(len(wav))

    width = fast.config.hidden_size

    def check(out):
        seg, feats = out["segments"], out["segment_features"]
        assert len(seg) and (seg[:, 1] > seg[:, 0]).all() and (seg[1:, 0] >= seg[:-1, 1]).all()
        assert seg[-1, 1] <= frames and feats.shape == (len(seg), width)
        assert np.isfinite(feats).all()

    segment_batch, enqueue = api.segment_batch, LongFormSegmenter._enqueue_windows
    api.segment_batch = forbid_host_syncs(torch, segment_batch)
    LongFormSegmenter._enqueue_windows = forbid_host_syncs(torch, enqueue)
    try:
        lf = LongFormSegmenter(fast, chunk_seconds=30.0, overlap_seconds=2.0, batch_windows=8)
        call = lambda: lf(wav=wav, in_second=False, return_hidden=False)  # noqa: E731
        call()  # warm-up: cuDNN plans at the window shape
        walls = []

        def timed_calls():
            for _ in range(3):
                t0 = time.perf_counter()
                out = call()
                walls.append(time.perf_counter() - t0)
            return out

        i16, lf_launches = counted("long-form int16 bf16 x3", timed_calls)
        check(i16)
        nwin = len(lf._starts(len(wav)))
        nbatch = -(-nwin // lf.batch_windows)
        prof = profile(torch, call)
        per_call = prof["launches"]
        rtfx = sorted(audio_s / w for w in walls)
        steps = longform_steps_ms(lf, wav)

        f32, _ = counted("long-form float32 windows bf16", lambda: LongFormSegmenter(
            fast, chunk_seconds=30.0, overlap_seconds=2.0, batch_windows=8,
            transfer="float32")(wav=wav, in_second=False, return_hidden=False))
        check(f32)
        t0 = time.perf_counter()
        hid, _ = counted("long-form return_hidden=True bf16", lambda: lf(
            wav=wav, in_second=False, return_hidden=True))
        hid_wall = time.perf_counter() - t0
        check(hid)
        if (hid["hidden_states"].shape != (frames, width)
                or not np.isfinite(hid["hidden_states"]).all()):
            raise AssertionError(f"stitched hidden track {hid['hidden_states'].shape}, "
                                 f"expected ({frames}, {width})")
        parity = Segmenter(hubert_config=HubertConfig())
        lf32 = LongFormSegmenter(parity, chunk_seconds=30.0, overlap_seconds=2.0, batch_windows=8)
        lf32(wav=wav, in_second=False, return_hidden=False)  # warm-up
        t0 = time.perf_counter()
        p32, _ = counted("long-form int16 fp32", lambda: lf32(
            wav=wav, in_second=False, return_hidden=False))
        fp32_rtfx = audio_s / (time.perf_counter() - t0)
        check(p32)
        del parity, lf32
    finally:
        api.segment_batch, LongFormSegmenter._enqueue_windows = segment_batch, enqueue
    torch.cuda.empty_cache()
    f1 = boundary_f1(i16["segments"], f32["segments"], tol_frames=0)
    report["longform"] = dict(audio_s=audio_s, windows=nwin, window_batches=nbatch,
                              rtfx_bf16_int16=rtfx[1], rtfx_bf16_int16_min=rtfx[0],
                              rtfx_bf16_int16_max=rtfx[-1], rtfx_fp32_int16=fp32_rtfx,
                              rtfx_bf16_return_hidden=audio_s / hid_wall,
                              segments=len(i16["segments"]), launches_per_call=per_call,
                              profile=prof, steps_ms=steps,
                              launches_per_window_batch=per_call / nbatch,
                              int16_vs_float32_f1_tol0=f1, kernel_launches=lf_launches)
    log(f"phase 5 long-form {audio_s:.0f} s, {nwin} windows of 30 s in {nbatch} batches: "
        f"RTFx bf16 int16 median {rtfx[1]:.1f} (min {rtfx[0]:.1f}, max {rtfx[-1]:.1f}) of 3 "
        f"calls; fp32 int16 {fp32_rtfx:.1f} (1 call); bf16 return_hidden=True "
        f"{audio_s / hid_wall:.1f} (1 call, hidden track {hid['hidden_states'].shape}); "
        f"{len(i16['segments'])} segments; int16 vs float32 windows F1 (tol 0) {f1:.5f}; "
        f"{per_call} launches a call, {per_call / nbatch:.0f} a window batch; the dispatch of "
        f"the window batches and segment_batch ran under set_sync_debug_mode('error'); "
        f"profiled call: device busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms; top: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["top_ms"][:6]) + "; one call in steps: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in steps.items()) + f"  [{smi}]")
    idle = [n for n in ("conv0_gn_gelu", "flash_attention", "segment_pass1", "segment_pass2")
            if lf_launches[n] == 0]
    if idle:
        raise AssertionError(f"long-form never launched {idle}")
    if per_call / nbatch >= 1000:
        raise AssertionError(f"long-form: {per_call / nbatch:.0f} launches a window batch")

    # ---- streaming: 60 s in 0.05-0.4 s pushes; each hop is process([4 s])
    for sec in (1, 2, 3, 4):  # the first hops' shorter windows, then the 4 s one
        fast.process([speechlike(np.random.RandomState(sec), sec * 16000)], return_hidden=False)
    hop_s = []
    process = fast.process

    def timed_process(*a, **k):
        t0 = time.perf_counter()
        out = process(*a, **k)
        hop_s.append(time.perf_counter() - t0)
        return out

    fast.process = timed_process
    try:
        stream_wav = speechlike(np.random.RandomState(60), 60 * 16000)
        commits, _ = counted("streaming 60 s", lambda: stream_commits(
            StreamingSegmenter, fast, stream_wav))
    finally:
        del fast.process
    hop = profile(torch, lambda: fast.process([stream_wav[-64000:]], return_hidden=False))
    report["streaming"] = dict(audio_s=60.0, hops=len(hop_s), commits=len(commits), profile=hop,
                               hop_ms_p50=percentile_ms(hop_s, 50),
                               hop_ms_p95=percentile_ms(hop_s, 95),
                               hop_ms_max=percentile_ms(hop_s, 100))
    r = report["streaming"]
    log(f"phase 5 streaming 60 s, window 4 s, hop 1 s: {r['hops']} hops, wall time a hop p50 "
        f"{r['hop_ms_p50']:.2f} ms, p95 {r['hop_ms_p95']:.2f} ms, max {r['hop_ms_max']:.2f} ms; "
        f"{len(commits)} commits, exactly once and in order; a profiled hop: device busy "
        f"{hop['device_ms']:.2f} of {hop['wall_ms']:.2f} ms, {hop['launches']} launches  [{smi}]")

    # ---- tokenizer: a seeded 10,000 x 768 codebook on the long-form features
    feats = i16["segment_features"].astype(np.float32)
    rng = np.random.RandomState(10000)
    codebook = (feats[rng.randint(0, len(feats), 10000)]
                + 0.5 * feats.std() * rng.randn(10000, width)).astype(np.float32)
    card_q, cpu_q = KMQuantizer(codebook, device="cuda"), KMQuantizer(codebook, device="cpu")
    x = torch.from_numpy(feats).cuda()
    tok_ms = time_ms(torch, lambda: card_q.get_indices(x), 5)
    card, cpu = encode(card_q, feats), encode(cpu_q, feats)
    ties, others = token_differences(card, cpu, feats, codebook)
    toks, _ = counted("tokenizer 2 utterances", lambda: SylberTokenizer(fast, quantizer=card_q)(
        wav=[speechlike(np.random.RandomState(s), 5 * 16000) for s in (7, 8)]))
    if not all(len(t["tokens"]) == len(t["segments"]) for t in toks):
        raise AssertionError("tokenizer: one token a segment")
    report["tokenizer"] = dict(features=len(feats), codebook=list(codebook.shape), ties=ties,
                               other_differences=others, distinct=len(set(card.tolist())),
                               nearest_ms=tok_ms)
    log(f"phase 5 tokenizer, 10000 x {width} codebook on {len(feats)} long-form features: tokens on "
        f"the card vs the CPU differ at {ties} ties and {others} other places; "
        f"{len(set(card.tolist()))} distinct ids; nearest-centroid search {tok_ms:.3f} ms on "
        f"the card  [{smi}]")
    if others:
        raise AssertionError(f"tokenizer: {others} tokens differ between card and CPU, not ties")

    # ---- server: the traffic of scripts/serving_probe.py
    rng = np.random.RandomState(0)
    pool = [speechlike(rng, int(rng.uniform(1.0, 8.0) * 16000)) for _ in range(64)]
    report["server"] = {}

    def serve_runs():
        for depth in (0, 1, 1, 0):  # in turns: the spread shows beside the difference
            server = SegmenterServer(fast, max_batch=32, max_wait_ms=10.0, pipeline_depth=depth)
            try:
                if not report["server"]:
                    server.warmup(lengths_s=(2.0, 4.0, 8.0))
                lat, audio, failures = [], [0.0], []
                lock = threading.Lock()

                def client(cid, record):
                    r = np.random.RandomState(cid)
                    for _ in range(16):
                        wav = pool[r.randint(len(pool))]
                        t0 = time.perf_counter()
                        try:
                            out = server.segment(wav)
                        except Exception as e:  # counted, and fails the phase below
                            with lock:
                                failures.append(repr(e))
                            continue
                        dt = time.perf_counter() - t0
                        assert "segments" in out
                        if record:
                            with lock:
                                lat.append(dt)
                                audio[0] += len(wav) / 16000.0

                def run_pass(record):
                    threads = [threading.Thread(target=client, args=(c, record))
                               for c in range(16)]
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=600)
                    if any(t.is_alive() for t in threads):
                        raise AssertionError("server: a client did not finish in 600 s")
                    return time.perf_counter() - t0

                run_pass(False)  # first use of every bucket of this traffic
                before = server.stats()
                wall = run_pass(True)
                after = server.stats()
            finally:
                server.stop()
            batches = after.batches - before.batches
            rec = dict(requests=len(lat), failures=len(failures) + after.failed,
                       latency_ms_p50=percentile_ms(lat, 50),
                       latency_ms_p95=percentile_ms(lat, 95),
                       latency_ms_p99=percentile_ms(lat, 99), throughput_rtfx=audio[0] / wall,
                       requests_per_s=len(lat) / wall, batches=batches,
                       mean_batch_size=(after.batched_items - before.batched_items) / batches)
            report["server"].setdefault(f"depth{depth}", []).append(rec)
            log(f"phase 5 server, 16 clients x 16 requests of 1-8 s, max_batch 32, max_wait 10 ms, "
                f"pipeline_depth {depth}: latency p50 {rec['latency_ms_p50']:.1f} ms, p95 "
                f"{rec['latency_ms_p95']:.1f} ms, p99 {rec['latency_ms_p99']:.1f} ms; throughput "
                f"{rec['throughput_rtfx']:.1f}x real time ({rec['requests_per_s']:.1f} req/s); "
                f"mean batch {rec['mean_batch_size']:.2f} over {batches} batches; "
                f"{rec['requests']} resolved, {rec['failures']} failed  [{smi}]")
            if rec["failures"] or rec["requests"] != 256:
                raise AssertionError(f"server depth {depth}: {failures[:3]}")

    counted("server depth 0, 1, 1, 0", serve_runs)

    # one request at a time equals process([wav]) bit for bit
    with SegmenterServer(fast, max_batch=32, max_wait_ms=1.0) as server:
        served = [server.segment(w) for w in pool[:8]]
    direct = [fast.process([w], return_hidden=False)[0] for w in pool[:8]]
    same = all(a["segments"].tolist() == b["segments"].tolist()
               and np.array_equal(a["segment_features"], b["segment_features"])
               for a, b in zip(served, direct))
    log(f"phase 5 server: 8 requests one at a time bit-identical to process([wav]): {same}")
    if not same:
        raise AssertionError("server: a lone request differs from process([wav])")

    # the speculative copy changes no output; 64 tokens a second holds every
    # segment of these random-weight utterances (one a frame). Its event is
    # what orders finalize's reads: a 100 ms sleep queued before the
    # segmentation holds the copy back while the host marks the pinned
    # buffers (-1, NaN), so a read without the wait sees the marks; one call
    # drops the event and must come out wrong, or the check could not fail
    batch = pool[:32]
    want = fast.process(batch, return_hidden=False)
    kmax = max(len(o["segments"]) for o in want)
    bucket_s = -(-max(len(w) for w in batch) // 16000)
    hold_cycles = int(0.1 * sm_clock_hz())
    start_host_copy, segment_batch = api.start_host_copy, api.segment_batch
    marked_at_dispatch, drop_wait = [], [False]

    def held(*a, **k):
        torch.cuda._sleep(hold_cycles)
        return segment_batch(*a, **k)

    def marked(*tensors):
        hosts, done = start_host_copy(*tensors)
        for h in hosts:
            h.fill_(float("nan") if h.is_floating_point() else -1)
        marked_at_dispatch.append(all(
            bool(h.isnan().all() if h.is_floating_point() else (h == -1).all()) for h in hosts))
        return hosts, (None if drop_wait[0] else done)

    def same(got):
        return all(a["segments"].tolist() == b["segments"].tolist()
                   and np.array_equal(a["segment_features"], b["segment_features"])
                   and np.array_equal(a["frame_norms"], b["frame_norms"])
                   for a, b in zip(got, want))

    api.start_host_copy, api.segment_batch = marked, held
    try:
        spec = {}
        for rate in (6.0, 0.01, 64.0):
            fast.speculative_tokens_per_s = rate
            k = int(np.ceil(bucket_s * rate)) + 8
            spec[rate] = dict(prefix_rows=k, prefix_used=kmax <= k,
                              identical=same(fast.process(batch, return_hidden=False)))
        drop_wait[0] = True
        without_wait = same(fast.process(batch, return_hidden=False))
        torch.cuda.synchronize()
    finally:
        api.start_host_copy, api.segment_batch = start_host_copy, segment_batch
        fast.speculative_tokens_per_s = None
    # what the option saves when the prefix holds every segment: process()
    # of the same batch without and with it, in turns
    walls = {None: [], 64.0: []}
    for _ in range(5):
        for rate in walls:
            fast.speculative_tokens_per_s = rate
            t0 = time.perf_counter()
            fast.process(batch, return_hidden=False)
            walls[rate].append(time.perf_counter() - t0)
    fast.speculative_tokens_per_s = None
    wall_ms = {str(r): percentile_ms(w, 50) for r, w in walls.items()}
    report["speculative"] = dict(max_segments=kmax, rates=spec,
                                 marked_at_dispatch=marked_at_dispatch,
                                 identical_without_wait=without_wait,
                                 process_ms_p50=wall_ms)
    log(f"phase 5 speculative_tokens_per_s on 32 requests (most segments {kmax}): "
        + "; ".join(f"{rate}/s: {v['prefix_rows']} rows, prefix used {v['prefix_used']}, "
                    f"identical {v['identical']}" for rate, v in spec.items())
        + f"; pinned buffers still marked when dispatch returned: {marked_at_dispatch}; "
        f"read without the event's wait identical: {without_wait}; process() p50 of 5 "
        f"without the option {wall_ms['None']:.2f} ms, at 64/s {wall_ms['64.0']:.2f} ms  [{smi}]")
    if not all(v["identical"] for v in spec.values()):
        raise AssertionError(f"speculative copy changed an output: {spec}")
    if not all(marked_at_dispatch) or without_wait:
        raise AssertionError("the speculative check cannot see a read without the event's wait: "
                             f"marked {marked_at_dispatch}, identical without it {without_wait}")

    # ---- the HTTP shim, as its users start it
    report["http"] = http_shim(codebook, str(fast.device))
    return report, launches


def longform_steps_ms(lf, wav):
    """One resident long-form call (``LongFormSegmenter.__call__`` with
    ``return_hidden=False``, the same calls in the same order) cut into its
    steps, wall ms each: preparing and uploading the int16 PCM and enqueuing
    every window batch; the fetch, the first host wait, so it also holds the
    device work still queued; the cuts and the stitching; the features,
    with the batched re-pool."""
    marks = [time.perf_counter()]
    starts = lf._starts(len(wav))
    raw = lf._dispatch_resident(wav, starts, None, None)
    marks.append(time.perf_counter())
    results = lf._collect_resident(raw)
    marks.append(time.perf_counter())
    stitched = lf._stitch_segments(starts, results, lf._cuts(starts, results))
    marks.append(time.perf_counter())
    lf._features_fast(starts, results, stitched)
    marks.append(time.perf_counter())
    return dict(zip(("dispatch", "fetch", "stitch", "features"),
                    (float(x) for x in np.diff(marks) * 1e3)))


def http_shim(codebook, device):
    """Start ``python -m sylber_tpu_torch.serve_http`` on a free port (bf16,
    seeded random weights, ``codebook`` for /tokenize), send it one int16
    body on /segment, /tokenize and /resynthesize, read /stats, stop it."""
    import urllib.error
    import urllib.request

    out_dir = ROOT / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "codebook_10000.npy", codebook)
    proc = subprocess.Popen([sys.executable, "-m", "sylber_tpu_torch.serve_http", "--device",
                             device, "--bf16", "--no-warmup", "--port", "0", "--centroids",
                             str(out_dir / "codebook_10000.npy")],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []

    def read():
        for ln in proc.stdout:
            lines.append(ln)

    threading.Thread(target=read, daemon=True).start()
    try:
        t0 = time.perf_counter()
        base = None
        while base is None:
            base = next((ln.split()[-1] for ln in list(lines) if ln.startswith("serving on")),
                        None)
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                raise AssertionError("serve_http did not start: " + "".join(lines)[-2000:])
            time.sleep(0.2)
        started = time.perf_counter() - t0
        pcm = np.clip(speechlike(np.random.RandomState(3), 3 * 16000) * 0.25 * 32767,
                      -32768, 32767).astype("<i2").tobytes()

        def post(path):
            req = urllib.request.Request(base + path, data=pcm, headers={"X-Dtype": "int16"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        codes = {}
        codes["segment"], seg = post("/segment")
        codes["tokenize"], tok = post("/tokenize")
        codes["resynthesize"], _ = post("/resynthesize")
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            codes["stats"], stats = r.status, json.loads(r.read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log(f"phase 5 HTTP shim (python -m sylber_tpu_torch.serve_http --device {device} --bf16, up in "
        f"{started:.1f} s): /segment {codes['segment']} ({seg.get('num_segments')} segments), "
        f"/tokenize {codes['tokenize']} ({len(tok.get('tokens', []))} tokens), /resynthesize "
        f"{codes['resynthesize']}, /stats {codes['stats']} ({stats['completed']} completed)")
    if (codes != {"segment": 200, "tokenize": 200, "resynthesize": 503, "stats": 200}
            or seg["num_segments"] != len(tok["tokens"]) or not seg["num_segments"]):
        raise AssertionError(f"HTTP shim answered {codes}")
    return dict(codes=codes, segments=seg["num_segments"], startup_s=started)


# ---------------------------------------------------------------- phase 6

def stage2_recipe(dtype: str, precision: str, batch: int, remat: bool = False):
    """The semantics of ``configs/sylber_base_stage2_tpu.yaml`` (its model
    keys; the synthetic corpus in place of LibriSpeech and DNS noise, which
    the repository does not hold) at ``dtype`` / ``precision``."""
    model = {"encoding_layer": 9, "ema_decay": 1.0, "segment_online": True,
             "merge_threshold_range": [0.8, 0.9],
             "thresholder_configs": {"signal_mean": 6.10, "signal_var": 0.87,
                                     "noise_mean": 0.34, "noise_var": 0.34},
             "use_train_thrupdate": True, "mask_prob": 0.0, "min_mask_n": 0,
             "do_noise_augment": True,
             "noise_mixer_configs": {"augment_prob": 0.2, "utterance_mix_ratio": 0.25,
                                     "shift_range": [0.0, 0.7],
                                     "magnitude_range": [0.05, 0.7],
                                     "utterance_magnitude_max_scale": 0.2},
             "lr": 0.00005, "warmup_steps": 0, "hold_steps": 0, "total_steps": 50000,
             "min_factor": 1, "loss_coefs": {"distillation_loss": 1},
             "dtype": dtype, "frontend_dtype": dtype, "precision": precision}
    if remat:
        model["hubert"] = {"remat": True}
    data = {"synthetic": True, "segment_online_data": True, "n_utts": batch,
            "max_len": 80000, "batch_size": batch, "transfer": "int16",
            "device_resident": True}
    return {"name": f"stage2_{dtype}", "seed": 0, "model": model, "data": data,
            "accumulate_grad_batches": 1}


def step_parts_ms(torch, state, batch, dcfg, seed=0):
    """One step in its parts, each between two CUDA events: the teacher's
    forward, the online segmentation, the student's forward and backward,
    the optimizer (the functions ``make_train_step`` runs, in its order)."""
    from sylber_tpu_torch.models.hubert import matmul_precision
    from sylber_tpu_torch.train import distill as D

    gens = D.step_generators(seed, state.step, "cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    params = list(state.student.parameters())
    for p in params:
        p.grad = None
    precision = matmul_precision(dcfg.model.precision)
    precision.__enter__()
    ev[0].record()
    wav, am, target = D.teacher_targets(state.teacher, batch)
    ev[1].record()
    segs, nseg, thr, norm_mask = D.online_segments(target, am, state.thresholder, gens, dcfg)
    ev[2].record()
    loss, aux = D.student_loss(state.student, wav, am, batch.get("noise"), target, segs, nseg,
                               thr, norm_mask, gens, dcfg)
    loss.backward()
    ev[3].record()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    schedule = D.cosine_warmup_schedule(dcfg.lr, dcfg.warmup_steps, dcfg.total_steps,
                                        dcfg.min_factor, dcfg.hold_steps)
    D.apply_gradients(params, grads, state.optimizer, state.acc_grads, state.step, dcfg,
                      schedule)
    ev[4].record()
    precision.__exit__(None, None, None)
    torch.cuda.synchronize()
    names = ("teacher", "segmentation", "student_fwd_bwd", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def training_run(torch, counters, label, recipe, out_dir, smi, steps=13, warm=3):
    """``train()`` for ``steps`` steps (every launch counter from 0, metrics
    fetched every step), then on the state it returns: one step under
    ``set_sync_debug_mode("error")`` with its launches, one profiled step and
    one step in parts."""
    from sylber_tpu_torch.train.distill import make_train_step
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train, train_batches
    from sylber_tpu_torch.utils.profiling import hubert_train_flops, mfu

    B = recipe["data"]["batch_size"]
    for fn in counters:
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train(recipe, out_dir=str(out_dir), max_steps=steps, log_every=1, ckpt_every=0,
                  device="cuda")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    rows = [json.loads(ln) for ln in open(Path(out_dir) / "metrics.jsonl")]
    rows = [r for r in rows if r["prefix"] == "train"]
    bad = [r for r in rows if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                   and np.isfinite(r["normthreshold"])
                                   and r["num_segments"] > 0)]
    if len(rows) != steps or bad:
        raise AssertionError(f"{label}: {len(rows)} metric rows, not finite or no segments: "
                             f"{bad[:2]}")
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])][warm - 1:]
    p50 = float(np.median(step_ms))

    dcfg = distill_config_from_dict(dict(recipe["model"], accumulate_grad_batches=1))
    step_fn = make_train_step(dcfg)
    batch = next(train_batches(recipe["data"], B, recipe["seed"], steps, torch.device("cuda")))
    attended_s = float(batch["attention_mask"].float().sum().item()) / 16000.0
    crop = batch["input_values"].shape[1]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    forbid_host_syncs(torch, step_fn)(state, batch, recipe["seed"])  # raises on a host sync
    torch.cuda.synchronize()
    per_step = {fn.__name__: fn.launches for fn in counters}
    prof = profile(torch, lambda: step_fn(state, batch, recipe["seed"]), top=8)
    parts = step_parts_ms(torch, state, batch, dcfg, recipe["seed"])
    flops = hubert_train_flops(dcfg.model, B, crop)
    dt = str(dcfg.model.dtype).replace("torch.", "")
    rec = dict(label=label, batch=B, crop_samples=crop, remat=dcfg.model.remat,
               step_ms=step_ms, step_ms_p50=p50, audio_s_per_s=B * crop / 16000.0 / (p50 / 1e3),
               attended_audio_s_per_s=attended_s / (p50 / 1e3), step_tflop=flops / 1e12,
               mfu=mfu(flops, p50 / 1e3, dt, dcfg.model.precision),
               peak=f"{dt} {dcfg.model.precision}", max_memory_allocated_gb=peak / 1e9,
               launches_over_run=launches, kernel_launches_per_step=per_step,
               profile=prof, parts_ms=parts, losses=[r["loss"] for r in rows],
               num_segments=[r["num_segments"] for r in rows])
    log(f"phase 6 {label}: B{B} x {crop} samples, remat {rec['remat']}: step p50 "
        f"{p50:.1f} ms (10 steps after 3 warm-up, min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}), {rec['audio_s_per_s']:.0f} audio s/s "
        f"({rec['attended_audio_s_per_s']:.0f} attended), {flops / 1e12:.2f} TFLOP a step, "
        f"MFU {100 * rec['mfu']:.1f} % of the {rec['peak']} peak, max_memory_allocated "
        f"{peak / 1e9:.1f} GB; loss {rows[0]['loss']:.4g} -> {rows[-1]['loss']:.4g}, "
        f"segments a step {rows[-1]['num_segments']:.0f}  [{smi}]")
    log(f"phase 6 {label}: one step under set_sync_debug_mode('error'): no host sync; the "
        f"port's kernels launched {per_step}; profiled step: device busy "
        f"{prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms (events summed "
        f"{prof['device_sum_ms']:.1f} ms, overlapping {prof['overlap_ms']:.1f} ms, "
        f"{prof['duplicate_events']} reported twice), {prof['launches']} launches; "
        f"top: " + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["top_ms"]))
    log(f"phase 6 {label}: step in parts (CUDA events): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items()))
    del state, batch
    torch.cuda.empty_cache()
    return rec


def training_shape_kernels(torch, ops):
    """The kernels at the trainer's shapes (B100 x 5 s crops): conv0 at
    100 x 80,320, small attention at B100 H12 L250 D64, and the whole
    segmentation at B100 L250 d768 with a 0-d device tensor as its norm
    threshold, against the plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    out = {}
    B, L, D = 100, 80320, 512
    x = randn(B, L)
    x[7, 50000:] = 0.0  # a shorter utterance padded to the crop
    w = randn(D, 1, 10) / 10 ** 0.5
    gamma, beta = 1 + 0.1 * randn(D), 0.1 * randn(D)
    out["conv0_gn_gelu"] = conv0_record(torch, ops, x, w, gamma, beta)
    del x
    out["small_attention"] = attention_record(torch, ops.smallattn.small_attention,
                                              ops.smallattn.small_attention_plain, 100, 250,
                                              gen, small=True)
    seg = ops.segment
    states = torch.from_numpy(synthetic_states(np.random.RandomState(6), 100, 250, 768)).to(dev)
    norms = seg.frame_norms(states)
    thr = torch.tensor(2.6, device=dev)  # as the thresholder hands it over
    fv = torch.ones(100, 250, dtype=torch.bool, device=dev)
    fv[7, 156:] = False
    got = forbid_host_syncs(torch, seg.segment_batch)(states, thr, 0.85, frame_valid=fv)
    want = segment_batch_plain(torch, seg, states, thr, 0.85, frame_valid=fv)
    mism = int((got.segments != want.segments).sum().item()
               + (got.num_segments != want.num_segments).sum().item())
    ferr = float((got.features - want.features).abs().max().item())
    out["segment_batch"] = dict(shape=[100, 250, 768], mismatches=mism, feature_err=ferr,
                                segments=int(got.num_segments.sum().item()),
                                ok=mism == 0 and ferr <= 1e-5)
    voiced = (norms >= thr) & fv
    out["segment_pass1"], out["segment_pass2"] = segmentation_records(
        torch, seg, states, voiced, norms, 0.85)
    return out


def card_against_cpu_step(torch):
    """One stage-2 step of ``mini_ckpt.npz`` (9 layers, 144 wide; fp32,
    highest, dropout 0) on the card and on the CPU from the same batch: loss
    within rtol 1e-4, segments equal, gradients within 1e-4 of the largest."""
    from sylber_tpu_torch.data.dataset import SyntheticSpeechDataset
    from sylber_tpu_torch.io.checkpoint import load_state_dict
    from sylber_tpu_torch.models.hubert import HubertConfig, matmul_precision
    from sylber_tpu_torch.train import distill as D

    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    model = HubertConfig(num_hidden_layers=meta["encoding_layer"], precision="highest",
                         hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                         feat_proj_dropout=0.0, **hub)
    dcfg = D.DistillConfig(model=model, segment_online=True, use_train_thrupdate=True,
                           merge_threshold_range=(0.8, 0.8), warmup_steps=0, lr=1e-3)
    sd = load_state_dict(str(FIXTURES / "mini_ckpt.npz"), meta["encoding_layer"])
    ds = SyntheticSpeechDataset(n_utts=4, max_len=48000, with_segments=False, seed=11)
    host = ds.collate([ds[i] for i in range(4)], transfer="int16")
    out = {}
    for dev in ("cuda", "cpu"):
        state = D.init_train_state(dcfg, dev, params=sd,
                                   thresholder_kwargs=meta["thresholder_stats"])
        batch = {k: (torch.from_numpy(v).to(dev) if v is not None else None)
                 for k, v in host.items()}
        gens = D.step_generators(0, 0, dev)
        with matmul_precision("highest"):  # forward and backward without TF32
            wav, am, target = D.teacher_targets(state.teacher, batch)
            segs, nseg, thr, norm_mask = D.online_segments(target, am, state.thresholder, gens,
                                                           dcfg)
            loss, _ = D.student_loss(state.student, wav, am, batch["noise"], target, segs, nseg,
                                     thr, norm_mask, gens, dcfg)
            loss.backward()
        out[dev] = dict(loss=float(loss.detach().cpu()), segments=segs.cpu().numpy(),
                        num_segments=nseg.cpu().numpy(),
                        grads={k: p.grad.detach().cpu() for k, p in
                               state.student.named_parameters() if p.grad is not None})
    g, c = out["cuda"], out["cpu"]
    same = bool(np.array_equal(g["num_segments"], c["num_segments"])
                and np.array_equal(g["segments"], c["segments"]))
    largest = max(float(v.abs().max()) for v in c["grads"].values())
    gerr = max(float((g["grads"][k] - v).abs().max()) for k, v in c["grads"].items())
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    rec = dict(loss_cuda=g["loss"], loss_cpu=c["loss"], loss_rel_err=rel, segments_equal=same,
               segments=int(c["num_segments"].sum()), grad_max_abs_err=gerr,
               grad_largest=largest, ok=bool(rel <= 1e-4 and same and gerr <= 1e-4 * largest
                                             and g["grads"].keys() == c["grads"].keys()))
    log(f"phase 6 card vs CPU, one stage-2 step of mini_ckpt.npz (B4 x 3 s, fp32 highest): loss "
        f"{g['loss']:.6g} vs {c['loss']:.6g} (rel {rel:.2g}, tol 1e-4), segments equal {same} "
        f"({rec['segments']}), max |grad diff| {gerr:.3g} of largest {largest:.3g} (tol 1e-4 "
        f"relative) ok={rec['ok']}")
    return rec


def remat_on_card(torch):
    """The student with ``remat`` (each encoder layer recomputed in the
    backward pass, its dropout masks drawn again from the layer's seed)
    against the same student without it, on the card, dropout 0.1 (mini
    width, 2 layers, fp32 highest, B4 x 2 s): the losses within 1e-6
    relative, the gradients within 1e-5 of the largest (a cuDNN backward
    may sum in another order from call to call)."""
    import dataclasses

    from sylber_tpu_torch.models.hubert import (HubertConfig, HubertModel, init_weights,
                                                matmul_precision)

    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    cfg = HubertConfig(num_hidden_layers=2, precision="highest", **hub)
    gen = torch.Generator().manual_seed(4)
    wav = torch.randn(4, 32320, generator=gen).cuda()
    mask = torch.ones(4, 32320, dtype=torch.int32, device="cuda")
    mask[3, 20000:] = 0
    out = []
    plain = init_weights(HubertModel(cfg), torch.Generator().manual_seed(4))
    for remat in (False, True):
        model = HubertModel(dataclasses.replace(cfg, remat=remat))
        model.load_state_dict(plain.state_dict())
        model = model.cuda().train()
        with matmul_precision("highest"):
            loss = model(wav, mask, generator=torch.Generator().manual_seed(9)).square().mean()
            loss.backward()
        out.append((float(loss.detach()), {k: p.grad.detach().cpu() for k, p in
                                           model.named_parameters() if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    largest = max(float(v.abs().max()) for v in g0.values())
    err = max(float((g1[k] - v).abs().max()) for k, v in g0.items())
    rec = dict(loss=l0, loss_remat=l1, grad_max_abs_err=err, grad_largest=largest,
               ok=bool(abs(l0 - l1) <= 1e-6 * abs(l0) and g0.keys() == g1.keys()
                       and err <= 1e-5 * largest))
    log(f"phase 6 remat on the card (dropout 0.1): loss {l0:.7g} vs {l1:.7g} with remat, max "
        f"|grad diff| {err:.3g} of largest {largest:.3g} (tols 1e-6, 1e-5 relative) ok={rec['ok']}")
    return rec


def resume_on_card(torch, tmp):
    """``train()`` on the card at mini width (seeded random weights, stage 2,
    synthetic B8 x 2 s): 4 steps at once, and 3 steps then a resumed fourth.
    The fourth step's loss within rtol 1e-6 and every parameter within atol
    1e-6 (cuDNN may pick a convolution backward whose sums are taken in
    another order); bit equality is reported beside."""
    from sylber_tpu_torch.train.loop import train

    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    recipe = {"seed": 3, "model": {
        "encoding_layer": 2, "hubert": dict(meta["hubert"]), "precision": "highest",
        "segment_online": True, "use_train_thrupdate": True,
        "merge_threshold_range": [0.8, 0.9], "do_noise_augment": True,
        "noise_mixer_configs": {"augment_prob": 0.5}, "lr": 1e-3, "warmup_steps": 1},
        "data": {"synthetic": True, "segment_online_data": True, "n_utts": 16,
                 "max_len": 32000, "batch_size": 8, "transfer": "int16"}}
    kw = dict(log_every=1, ckpt_every=1, device="cuda")
    train(recipe, out_dir=str(tmp / "whole"), max_steps=4, **kw)
    train(recipe, out_dir=str(tmp / "resumed"), max_steps=3, **kw)
    train(recipe, out_dir=str(tmp / "resumed"), max_steps=4, **kw)
    a, b = (np.load(tmp / d / "params_final.npz") for d in ("whole", "resumed"))
    err = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
    bits = all(np.array_equal(a[k], b[k]) for k in a.files)
    la, lb = ([json.loads(ln) for ln in open(tmp / d / "metrics.jsonl")][-1]["loss"]
              for d in ("whole", "resumed"))
    rows_b = [json.loads(ln) for ln in open(tmp / "resumed" / "metrics.jsonl")]
    rel = abs(la - lb) / abs(la)
    rec = dict(loss_step4=la, loss_step4_resumed=lb, loss_rel_err=rel, param_max_abs_err=err,
               bit_equal=bits, steps_logged=[r["step"] for r in rows_b],
               ok=bool(rel <= 1e-6 and err <= 1e-6 and a.files == b.files
                       and [r["step"] for r in rows_b] == [1, 2, 3, 4]))
    log(f"phase 6 resume on the card: step 4 loss {la:.7g} uninterrupted vs {lb:.7g} resumed "
        f"from the step-3 checkpoint (rel {rel:.2g}, tol 1e-6), parameters max |diff| {err:.3g} "
        f"(tol 1e-6), bit-equal {bits} ok={rec['ok']}")
    return rec


def training_phase(torch, ops, counters, smi, tmp):
    """Phase 6: the trainer on the card. Any failed check raises."""
    from sylber_tpu_torch.models.hubert import matmul_precision

    with matmul_precision("highest"):  # the plain versions' convs without TF32
        shapes = training_shape_kernels(torch, ops)
    for name in ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2"):
        for dt, r in shapes[name].items():
            log(f"phase 6: {name} {dt} at the trainer's shape {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']}) ok={r['ok']}  kernel_ms "
                f"{r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})  [{smi}]")
    sb = shapes["segment_batch"]
    log(f"phase 6: segment_batch at {sb['shape']} with a device-tensor norm threshold, under "
        f"set_sync_debug_mode('error'): {sb['mismatches']} mismatches, feature err "
        f"{sb['feature_err']:.3g}, {sb['segments']} segments ok={sb['ok']}")
    bad = [n for n, r in shapes.items()
           if not (r["ok"] if "ok" in r else all(x["ok"] for x in r.values()))]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the trainer's "
                             f"shapes: {bad}")
    runs = [training_run(torch, counters, "bf16_default_B100",
                         stage2_recipe("bfloat16", "default", 100), tmp / "bf16", smi),
            training_run(torch, counters, f"fp32_highest_B{FP32_BATCH}",
                         stage2_recipe("float32", "highest", FP32_BATCH, FP32_REMAT),
                         tmp / "fp32", smi)]
    launches = {}
    for r in runs:
        idle = [k for k in ("conv0_gn_gelu", "small_attention", "segment_pass1",
                            "segment_pass2") if r["launches_over_run"][k] == 0]
        if idle:
            raise AssertionError(f"{r['label']}: kernels of the training path never "
                                 f"launched: {idle}")
        for k, v in r["launches_over_run"].items():
            launches[k] = launches.get(k, 0) + v
    checks = [card_against_cpu_step(torch), resume_on_card(torch, tmp / "resume"),
              remat_on_card(torch)]
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"phase 6 checks failed: {checks}")
    return dict(kernels=shapes, runs=runs, launches=launches, card_vs_cpu=checks[0],
                resume=checks[1], remat=checks[2])


# ---------------------------------------------------------------- phase 7

# fp32 attention at the regressor's softmax scale of 10 after QK-RMSNorm
# (|q| = |k| = 8): scores reach +-640, so their float32 rounding, and the
# exponent's, is 80 times that of the encoder's unit-scale scores
REGRESSOR_ATTN_TOL = 1e-4


def regressor_attention_records(torch, ops):
    """Both attention kernels at the regressor's shapes, fp32, scale 10,
    every key valid (no mask at inference), on (B, H, L, D) views of
    (B, L, H, D) memory with |q| = |k| = 8 as QK-RMSNorm leaves them: the
    small kernel at B8 H8 L265 D64 (8 x 5 s: 249 frames + 16 registers) and
    flash at B1 H8 L1015 D64 (20 s: 999 + 16); against the plain versions,
    times, bounds and SDPA with the same scale."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, B, L, fn, plain_fn in (
            ("small_attention", 8, 265, ops.smallattn.small_attention,
             ops.smallattn.small_attention_plain),
            ("flash_attention", 1, 1015, ops.flash.flash_attention,
             ops.flash.flash_attention_plain)):
        H, D, scale = 8, 64, 10.0
        q, k, v = (torch.randn(B, L, H, D, device=dev, generator=gen).transpose(1, 2)
                   for _ in range(3))
        q, k = (8.0 * t / t.norm(dim=-1, keepdim=True) for t in (q, k))
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        run = lambda: fn(q, k, v, lens, scale)  # noqa: E731
        plain = lambda: plain_fn(q, k, v, lens, scale)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=REGRESSOR_ATTN_TOL, atol=REGRESSOR_ATTN_TOL)
        nbytes = 4 * B * L * H * D * 4 + 4 * B
        b_ms, b_by = bound_ms(nbytes, 4.0 * H * D * L * L * B, "float32")
        out[name] = {"float32": dict(
            max_abs_err=err, tol=REGRESSOR_ATTN_TOL, ok=bool(ok), scale=scale,
            ms=graph_time_ms(torch, run, 20), plain_ms=graph_time_ms(torch, plain, 5),
            library_ms=graph_time_ms(torch, library, 20), eager_ms=time_ms(torch, run, 20),
            bound_ms=b_ms, bound_by=b_by, shape=[B, H, L, D])}
    return out


def resynthesis_parts_ms(torch, synth, vocoder, wav, mask, cond_scale, spk):
    """One wav -> wav call in parts, timed by CUDA events: encoder +
    segmentation, conditioning (fill + input MLP), sampler, vocoder."""
    from sylber_tpu_torch.models.hubert import feature_vector_attention_mask, matmul_precision
    from sylber_tpu_torch.ops.segment import averaged_target_fill, segment_batch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        hidden = synth.hubert(wav, mask).float()
        fv = feature_vector_attention_mask(synth.config.hubert, mask, hidden.shape[1]).bool()
        with matmul_precision("highest"):
            res = segment_batch(hidden, synth.default_normthreshold, 0.8, frame_valid=fv)
        ev[1].record()
        cond = synth.cond_from_features(averaged_target_fill(hidden, res.segments,
                                                             res.num_segments), quantize=False)
        ev[2].record()
        art = synth.sample(cond, 5, cond_scale=cond_scale)
        ev[3].record()
        vocoder.waveform(art, spk)
        ev[4].record()
    torch.cuda.synchronize()
    names = ("encoder_segmentation", "conditioning", "sampler", "vocoder")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}, cond


def check_resynthesis_outputs(art, segs, audio, wavs, cfg):
    for i, w in enumerate(wavs):
        t = cfg.hubert.feat_extract_output_length(len(w))
        assert art.shape[1:] == (t, 14) and np.isfinite(art[i]).all(), art.shape
        seg = segs[i]
        assert len(seg) and (seg[:, 0] < seg[:, 1]).all() and seg.max() <= t
        assert audio.shape[1] == t * 320 and np.isfinite(audio[i]).all()
        assert np.abs(audio[i]).max() <= 1.0


def resynthesis_full_width(torch, counters, smi):
    """Full width, seeded random weights (``configs/sylber_resynthesis.yaml``
    + ``SparcDecoderConfig()``): resynthesize + decode_audio on 8 x 5 s and
    1 x 20 s, midpoint with 5 steps (8 regressor calls), cond_scale 1 and
    1.5, fp32 under "highest" and "default" (TF32) precision. Every launch
    counter from 0; each kernel of the path must launch."""
    import dataclasses
    import warnings

    import yaml

    from sylber_tpu_torch.synthesis import SegmentSynthesis, SynthesisConfig
    from sylber_tpu_torch.vocoder import SparcDecoder

    yaml_cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    base = SynthesisConfig.from_yaml_dict(yaml_cfg)
    rng = np.random.RandomState(7)
    batches = {"8x5s": [speechlike(rng, 5 * 16000) for _ in range(8)],
               "1x20s": [speechlike(rng, 20 * 16000)]}
    dev = torch.device("cuda")
    runs = []
    for fn in counters:
        fn.launches = 0
    for precision in ("highest", "default"):
        cfg = dataclasses.replace(
            base, hubert=dataclasses.replace(base.hubert, precision=precision),
            regressor=dataclasses.replace(base.regressor, precision=precision))
        synth = SegmentSynthesis(config=cfg, thresholder_configs=yaml_cfg["thresholder_configs"],
                                 device=dev)
        vocoder = SparcDecoder(device=dev, precision=precision)
        for bname, wavs in batches.items():
            wav_np = np.stack(wavs)
            spk = np.zeros((len(wavs), 64), np.float32)
            wav = torch.from_numpy(wav_np).to(dev)
            mask = torch.ones(wav.shape, dtype=torch.int32, device=dev)
            audio_s = wav_np.size / 16000.0
            for cs in (1.0, 1.5):
                def call():
                    art, segs = synth.resynthesize(input_values=wav_np, steps=5, cond_scale=cs)
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")  # random-init vocoder: noise, not speech
                        return art, segs, synth.decode_audio(art, spk, vocoder=vocoder)
                call()  # warm-up: cuDNN plans, cuBLAS handles
                torch.cuda.synchronize()
                walls = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    art, segs, audio = call()
                    walls.append(time.perf_counter() - t0)
                check_resynthesis_outputs(art, segs, audio, wavs, cfg)
                rtfx = sorted(audio_s / w for w in walls)
                parts, cond = resynthesis_parts_ms(torch, synth, vocoder, wav, mask, cs,
                                                   torch.from_numpy(spk).to(dev))
                sampler = lambda: synth.sample(cond, 5, cond_scale=cs)  # noqa: E731
                forbid_host_syncs(torch, sampler)()
                _, sampler_launches = count_launches(torch, sampler)
                torch.cuda.reset_peak_memory_stats()
                call()
                peak = torch.cuda.max_memory_allocated()
                prof = profile(torch, call)
                runs.append(dict(precision=precision, batch=bname, cond_scale=cs,
                                 audio_s=audio_s, wall_s=walls, rtfx=rtfx[2],
                                 rtfx_min=rtfx[0], rtfx_max=rtfx[-1], parts_ms=parts,
                                 sampler_launches=sampler_launches,
                                 segments=int(sum(len(x) for x in segs)),
                                 max_memory_allocated=peak, profile=prof))
                log(f"phase 7 full width {precision} {bname} cond_scale {cs}: {audio_s:.0f} s "
                    f"audio, wav -> wav RTFx median of 5 {rtfx[2]:.1f} (min {rtfx[0]:.1f}, max "
                    f"{rtfx[-1]:.1f}); parts ms " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                             parts.items())
                    + f"; sampler (8 regressor calls{', 2B rows' if cs != 1.0 else ''}): "
                    f"{sampler_launches} launches, no host sync; profiled call: device busy "
                    f"{prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms, {prof['launches']} "
                    f"launches; max_memory_allocated {peak / 2 ** 30:.2f} GiB; top: "
                    + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["top_ms"][:5])
                    + f"  [{smi}]")
        del synth, vocoder
        torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches for fn in counters}
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the resynthesis path: {idle}")
    return runs, launches


def _mini_synth(torch, name, device, quantizer=None):
    """A SegmentSynthesis of a trained mini fixture on ``device``, fp32 at
    "highest" precision on both sides, and its metadata's model block."""
    import dataclasses

    from sylber_tpu_torch.io.checkpoint import load_params_npz
    from sylber_tpu_torch.synthesis import SegmentSynthesis, synthesis_config_from_dict

    mc = json.loads((FIXTURES / f"{name}.json").read_text())["config"]["model"]
    cfg = synthesis_config_from_dict(mc)
    cfg = dataclasses.replace(cfg, regressor=dataclasses.replace(cfg.regressor,
                                                                 precision="highest"))
    params = {"hubert": load_params_npz(str(FIXTURES / "mini_ckpt.npz")),
              **load_params_npz(str(FIXTURES / f"{name}.npz"))}
    return SegmentSynthesis(config=cfg, params=params, quantizer=quantizer,
                            device=device), mc


def mini_corpus(n, seconds, seed, style="v1"):
    """(wav, art) utterances as the JAX trainer's synthesis corpus builds
    them: zero mean, unit variance, 160 samples of silence each side."""
    from sylber_tpu_torch.data.dataset import _zero_mean_unit_var
    from sylber_tpu_torch.data.synthetic import synth_utterance

    rng = np.random.RandomState(seed)
    n_samples = int(seconds * 16000) // 320 * 320
    wavs, arts = [], []
    for _ in range(n):
        wav, _segs, art = synth_utterance(rng, n_samples, return_art=True, style=style)
        pad = np.zeros(160, np.float32)
        wavs.append(np.concatenate([pad, _zero_mean_unit_var(wav), pad]))
        arts.append(art)
    return np.stack(wavs), np.stack(arts)


def rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def segment_tokens(torch, synth, wav, nt):
    """The tokens and features of a wav batch's valid segments, (n, codes)
    and (n, d) on the host, as the wav path computes them (the quantizer
    takes the whole (B, MS, d) batch: the distance matmul's shape sets its
    rounding)."""
    from sylber_tpu_torch.models.hubert import feature_vector_attention_mask, matmul_precision
    from sylber_tpu_torch.ops.segment import segment_batch

    with torch.inference_mode():
        w = torch.from_numpy(wav).to(synth.device)
        mask = torch.ones(w.shape, dtype=torch.int32, device=synth.device)
        hidden = synth.hubert(w, mask).float()
        fv = feature_vector_attention_mask(synth.config.hubert, mask, hidden.shape[1]).bool()
        with matmul_precision("highest"):
            res = segment_batch(hidden, nt, 0.8, frame_valid=fv)
        idx = synth.quantizer.get_indices(res.features).cpu().numpy()
    n = res.num_segments.cpu().numpy()
    feats = res.features.cpu().numpy()
    return (np.concatenate([idx[b, :n[b]] for b in range(len(n))]),
            np.concatenate([feats[b, :n[b]] for b in range(len(n))]))


def vq_gaps(torch, tok, feats, got, want):
    """For each segment whose token differs (``got`` against ``want``, rows
    of (art, pitch) codes, one group and one quantizer each): the gap
    between the squared distances of its two codes, on the CPU, relative to
    the scale the search computes them at (|x|^2 + |c|^2: the distances
    come from the expanded form |c|^2 - 2 x.c)."""
    from sylber_tpu_torch.flow.quantizer import quantizer_forward

    emb = quantizer_forward(tok.state, tok.cfg, torch.from_numpy(feats))["non_quantized"]
    split = [emb[..., :-tok.cfg.pitch_emb_dim], emb[..., -tok.cfg.pitch_emb_dim:]]
    books = [tok.state.art_vq.codebooks[0, 0], tok.state.pitch_vq.codebooks[0, 0]]
    gaps = []
    for i, j in zip(*np.nonzero(got != want)):
        x, c = split[j][i], books[j][[int(got[i, j]), int(want[i, j])]]
        d = ((x[None] - c) ** 2).sum(-1)
        scale = (x ** 2).sum() + (c ** 2).sum(-1).max()
        gaps.append(float((d[0] - d[1]).abs() / scale))
    return gaps


def resynthesis_mini_agreement(torch, device="cuda"):
    """The trained mini fixtures on the card against the CPU, each check
    with its tolerance: mini_synth (wav path midpoint: segments equal, art
    within 1e-4 of the largest; feature path tsit5: both complete, counts
    within 2, art within 1e-2: the controller reads its error estimate near
    the float32 rounding of the field), mini_synth_rich_pitch (the pitch
    path: segments equal, art within 1e-3, F0 frames that differ counted),
    mini_vq_synth + mini_vq_tokenizer (the token path: segments equal, a
    token differing only at a near-tie of its codes, art within 1e-4 where
    no token differs), mini_vocoder (0.2 s waveform within 1e-4; 5 s
    through log_mel, mean difference within 1e-2)."""
    import dataclasses

    from sylber_tpu_torch.flow.quantizer import GroupedResidualVQConfig, QuantizerConfig
    from sylber_tpu_torch.io.checkpoint import load_params_npz
    from sylber_tpu_torch.ops.pitch import frame_f0
    from sylber_tpu_torch.vocoder import HiFiGANConfig, SparcDecoder, SparcDecoderConfig
    from sylber_tpu_torch.vocoder.mel import log_mel
    from sylber_tpu_torch.vq_tokenizer import TrainedVQTokenizer

    checks = []

    def add(name, ok, **kw):
        checks.append(dict(check=name, ok=bool(ok), **kw))
        log(f"phase 7 mini card vs CPU, {name}: "
            + ", ".join(f"{k} {v}" for k, v in kw.items()) + f" ok={bool(ok)}")

    wav, _ = mini_corpus(2, 3.0, 424242)
    gpu, mc = _mini_synth(torch, "mini_synth", device)
    cpu, _ = _mini_synth(torch, "mini_synth", "cpu")
    nt = float(mc["norm_threshold"])
    (ag, sg), (ac, sc) = (s.resynthesize(input_values=wav, steps=5, normthreshold=nt)
                          for s in (gpu, cpu))
    same = all(np.array_equal(a, b) for a, b in zip(sg, sc))
    add("mini_synth wav path midpoint 5 steps", same and rel_err(ag, ac) <= 1e-4,
        segments_equal=same, art_err_of_largest=rel_err(ag, ac), tol=1e-4)
    feats = np.random.RandomState(5).randn(2, 40, 144).astype(np.float32)
    feats[:, 17] = 0.0  # a blank frame
    out = {}
    for name, s in (("gpu", gpu), ("cpu", cpu)):
        cond = s.cond_from_features(torch.from_numpy(feats).to(s.device))
        art, st = s.sample(cond, method="tsit5", return_stats=True)
        out[name] = (art.cpu().numpy(), {k: float(v) for k, v in st.items()})
    (ag, stg), (ac, stc) = out["gpu"], out["cpu"]
    dcount = abs(stg["accepted"] - stc["accepted"]) + abs(stg["rejected"] - stc["rejected"])
    add("mini_synth feature path tsit5", stg["complete"] and stc["complete"] and dcount <= 2
        and rel_err(ag, ac) <= 1e-2, card_stats=stg, cpu_stats=stc,
        art_err_of_largest=rel_err(ag, ac), tol=1e-2)

    wav, _ = mini_corpus(2, 3.0, 31337, style="rich")
    gpu, mc = _mini_synth(torch, "mini_synth_rich_pitch", device)
    cpu, _ = _mini_synth(torch, "mini_synth_rich_pitch", "cpu")
    nt = float(mc["norm_threshold"])
    (ag, sg), (ac, sc) = (s.resynthesize(input_values=wav, steps=5, normthreshold=nt)
                          for s in (gpu, cpu))
    f0g = frame_f0(torch.from_numpy(wav).to(device))[0].cpu().numpy()
    f0c = frame_f0(torch.from_numpy(wav))[0].numpy()
    same = all(np.array_equal(a, b) for a, b in zip(sg, sc))
    add("mini_synth_rich_pitch wav path (explicit pitch)", same and rel_err(ag, ac) <= 1e-3,
        segments_equal=same, f0_frames_differing=int((f0g != f0c).sum()),
        f0_frames=int(f0c.size), art_err_of_largest=rel_err(ag, ac), tol=1e-3)

    qd = json.loads((FIXTURES / "mini_vq_synth.json").read_text())["quantizer_config"]
    qcfg = QuantizerConfig(
        input_dim=qd["input_dim"], output_dim=qd["output_dim"],
        hidden_dims=tuple(qd["hidden_dims"]), pitch_emb_dim=qd["pitch_emb_dim"],
        art_vq=GroupedResidualVQConfig(**qd["art_vq"]),
        pitch_vq=GroupedResidualVQConfig(**qd["pitch_vq"]))
    tok = {d: TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg,
                                          device=d) for d in (device, "cpu")}
    wav, _ = mini_corpus(2, 3.0, 777001)
    gpu, mc = _mini_synth(torch, "mini_vq_synth", device, tok[device])
    cpu, _ = _mini_synth(torch, "mini_vq_synth", "cpu", tok["cpu"])
    nt = float(mc["norm_threshold"])
    (ag, sg), (ac, sc) = (s.resynthesize(input_values=wav, steps=5, normthreshold=nt)
                          for s in (gpu, cpu))
    same = all(np.array_equal(a, b) for a, b in zip(sg, sc))
    # the tokens of the utterances' segments, from each side's features; a
    # token may differ only where its two codes are within 1e-4 of each
    # other in distance (then the art differs too, and is not compared)
    (tg, _), (tc, fc) = (segment_tokens(torch, s, wav, nt) for s in (gpu, cpu))
    gaps = vq_gaps(torch, tok["cpu"], fc, tg, tc)
    add("mini_vq_synth token path", same and all(g <= 1e-4 for g in gaps)
        and (bool(gaps) or rel_err(ag, ac) <= 1e-4), segments_equal=same,
        tokens=int(len(tc)), token_differences=len(gaps),
        relative_distance_gaps=[f"{g:.2g}" for g in gaps],
        art_err_of_largest=rel_err(ag, ac), tol="1e-4 where no token differs")

    meta = json.loads((FIXTURES / "mini_vocoder.json").read_text())
    dcfg = SparcDecoderConfig(generator=HiFiGANConfig(**meta["generator"]))
    tree = load_params_npz(str(FIXTURES / "mini_vocoder.npz"))
    decs = {d: SparcDecoder(dcfg, params=tree, device=d, precision="highest")
            for d in (device, "cpu")}
    _, arts = mini_corpus(2, 5.0, 90909)
    spk = np.zeros((2, 64), np.float32)
    for n_frames, label in ((10, "0.2 s"), (arts.shape[1], "5 s")):
        a = arts[:, :n_frames]
        noise = torch.randn(2, n_frames * 320, generator=torch.Generator().manual_seed(0))
        wg = decs[device].waveform(a, spk, meta["pitch_mean"], noise=noise.to(device)).cpu()
        wc = decs["cpu"].waveform(a, spk, meta["pitch_mean"], noise=noise)
        err = float((wg - wc).abs().max())
        if n_frames == 10:
            add(f"mini_vocoder waveform {label}", err <= 1e-4, max_abs_err=err, tol=1e-4)
        else:
            dm = (log_mel(wg) - log_mel(wc)).abs()
            add(f"mini_vocoder {label} through log_mel", float(dm.mean()) <= 1e-2,
                waveform_max_abs_err=err, log_mel_mean_abs_diff=float(dm.mean()),
                log_mel_max_abs_diff=float(dm.max()), tol_mean=1e-2)
    return checks


def resynthesis_phase(torch, ops, counters, smi):
    """Phase 7: the resynthesis chain on the card. Any failed check raises."""
    from sylber_tpu_torch.models.hubert import matmul_precision

    with matmul_precision("highest"):
        shapes = regressor_attention_records(torch, ops)
    for name, rec in shapes.items():
        r = rec["float32"]
        log(f"phase 7: {name} float32 at the regressor's shape {r['shape']}, scale "
            f"{r['scale']}: max_abs_err {r['max_abs_err']:.3g} (tol {r['tol']}) ok={r['ok']}  "
            f"kernel_ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  library_ms (SDPA) "
            f"{r['library_ms']:.4f}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']})  [{smi}]")
    bad = [n for n, rec in shapes.items() if not rec["float32"]["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the regressor's "
                             f"shapes: {bad}")
    runs, launches = resynthesis_full_width(torch, counters, smi)
    log(f"phase 7: launches over the full-width resynthesis runs: {launches}  [{smi}]")
    mini = resynthesis_mini_agreement(torch)
    if not all(c["ok"] for c in mini):
        raise AssertionError(f"phase 7 card vs CPU failed: {[c for c in mini if not c['ok']]}")
    return dict(kernels=shapes, runs=runs, launches=launches, mini=mini)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON to this path")
    ap.add_argument("--only-resynthesis", action="store_true",
                    help="build the kernels and run phase 7 alone (a quicker check while "
                         "working on the resynthesis chain); prints no result line")
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

    counters = [ops.frontend.conv0_gn_gelu, ops.smallattn.small_attention,
                ops.flash.flash_attention, ops.segment.segment_pass1,
                ops.segment.segment_pass2]
    if args.only_resynthesis:
        resynthesis_phase(torch, ops, counters, smi)
        return 0

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
    for e in edges[-2:]:  # the streaming hop's shape
        log(f"phase 2: {e['kernel']} {e['dtype']} {e['shape']} (a streaming hop): max_abs_err "
            f"{e['max_abs_err']:.3g} (tol {e['tol']}) ok={e['ok']}")
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

    consumers, consumer_launches = consumers_full_width(torch, Segmenter, HubertConfig,
                                                        counters, smi)
    log(f"phase 5: launches over the consumers' runs: {consumer_launches}  [{smi}]")
    launches = {k: v + consumer_launches[k] for k, v in launches.items()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        training = training_phase(torch, ops, counters, smi, Path(tmp))
    log(f"phase 6: launches over the two training runs: {training['launches']}  [{smi}]")
    launches = {k: v + training["launches"][k] for k, v in launches.items()}

    resynthesis = resynthesis_phase(torch, ops, counters, smi)
    launches = {k: v + resynthesis["launches"][k] for k, v in launches.items()}

    sources = {"conv0_gn_gelu": ("frontend.cu", "sylber_tpu/ops/pallas/frontend.py:122"),
               "small_attention": ("smallattn.cu", "sylber_tpu/ops/pallas/smallattn.py:78"),
               "flash_attention": ("flash.cu", "sylber_tpu/ops/pallas/flash.py:125"),
               "segment_pass1": ("segment_scan.cu", "sylber_tpu/ops/segment.py:49"),
               "segment_pass2": ("segment_scan.cu", "sylber_tpu/ops/segment.py:129")}
    line = []
    for name, rec in checks.items():
        if name not in sources:  # another shape of a kernel, kept in that kernel's entry
            continue
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
    entries = {e["name"]: e for e in line}
    entries["flash_attention"]["longform_shape"] = {
        dt: {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                               "eager_ms", "bound_ms", "bound_by")}
        for dt, r in checks[LONGFORM_FLASH].items()}
    # the consumers' shapes that phase 2 held against the plain versions
    entries["small_attention"]["consumer_shapes"] = [
        {k: e[k] for k in ("shape", "dtype", "max_abs_err", "tol", "ok")} for e in edges[-2:]]
    entries["conv0_gn_gelu"]["consumer_shapes"] = [
        {k: e[k] for k in ("input", "shape", "dtype", "max_abs_err", "tol", "ok")}
        for e in conv0_edges if e["input"] in ("longform_window_batch", "streaming_hop")]
    for name in ("segment_pass1", "segment_pass2"):  # both run in each segment_batch call
        entries[name]["consumer_shapes"] = [
            {k: e[k] for k in ("case", "shape", "mismatches", "feature_err", "ok")}
            for e in seg_edges if e["case"] in ("longform_B8_L1549", "streaming_B1_L199")]
    # the trainer's shapes (phase 6): times, bounds and the plain versions there
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "eager_ms", "bound_ms",
            "bound_by")
    for name in ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2"):
        entries[name]["training_shapes"] = {
            dt: {k: r[k] for k in keys if k in r} for dt, r in training["kernels"][name].items()}
        entries[name]["training_launches"] = training["launches"][name]
    entries["segment_pass1"]["training_shapes"]["segment_batch"] = training["kernels"][
        "segment_batch"]
    entries["flash_attention"]["training_shapes"] = None  # 5 s crops: L 250, small attention
    entries["flash_attention"]["training_launches"] = training["launches"]["flash_attention"]
    # the regressor's shapes (phase 7) and every kernel's launches over its runs
    for name, rec in resynthesis["kernels"].items():
        entries[name]["resynthesis_shape"] = rec["float32"]
    for name, entry in entries.items():
        entry["resynthesis_launches"] = resynthesis["launches"][name]
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
                                                  mini_ckpt=mini, consumers=consumers,
                                                  training=training,
                                                  resynthesis=resynthesis),
                                             indent=1))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
