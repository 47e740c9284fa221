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
   every frame count; pass 2 is timed at each of its shapes beside its byte
   bound and its chain bound (the longest chain of mid boundaries, a chain
   being boundaries each of whose segment index is the one before's + 1,
   times ``pass2_chain_cycles``), with the chains counted;
3. run the ``Segmenter`` at full hubert-base width (768 wide, 9 layers,
   seeded random weights) in fp32 parity mode and bf16 fast mode on a
   32 x 5 s batch (small-attention path) and a 32 x 12-20 s batch (flash
   path), with every launch counter set to 0 just before and read just
   after; every kernel must have launched; the segmentation runs with
   ``torch.cuda.set_sync_debug_mode("error")``, so a wait for the host
   inside it fails the run; prints the real-time factor of five timed calls
   and the chains of mid boundaries that pass 2 meets there;
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
   parts; the bf16 run traces steps 3-5 (``train(profile_steps=(3, 5))``),
   and its Chrome trace must name the port's kernels (its timed steps then
   start at step 6); one stage-2 step of ``mini_ckpt.npz`` on the card
   against the CPU;
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
   ``--only-resynthesis`` runs phases 1 and 7 alone and prints no result;
8. the resynthesis trainers: the k-means++ seeding kernel against its
   plain version (the plain steps replayed on the kernel's rows, a row
   differing only at a float64/float32 tie) at the mini shapes (n 4,096,
   d 144, k 64 / 256 / 1,024), the VQ widths (d 24, 8), an awkward n
   (5,003), a pool of 256 distinct points each repeated 16 times (each
   taken once), full width (n 65,536, d 768, k 2,000) and the fit pool at
   the codebooks' width (n 65,536, d 144, k 5,000 / 10,000 / 20,000): two
   calls' rows identical, one kernel launch a call (the wrapper's count; the
   profiler, where it keeps a call's events, sees no other launch of it),
   timed beside its plain version, the grid and resident share of its
   plan, the round trip of its exchange of every block's sum to every
   block, its grid barrier (a launch of k exchange-only steps),
   and its bounds (x each step, the on-chip bytes, the chain);
   ``fit_kmeans`` at 5,000 centers on
   65,536 x 768 seeded features (its seeding launch counted from 0);
   ``train_synthesis`` at full width (``configs/sylber_resynthesis.yaml``,
   seeded random encoder, 128 synthetic utterances, B64 x 5 s) under
   "highest" and "default", 13 steps each with every counter from 0 (the
   precompute must launch conv0, small attention and both segmentation
   passes), step p50, frames a second, MFU, peak memory, one step under
   ``set_sync_debug_mode("error")``, a profiled step, and
   ``evaluate_synthesis`` on 8 held-out utterances (small attention must
   launch); one joint-VQ step and a ``make_vocoder_train_step`` step
   (``SparcDecoderConfig()``, B16 x 32 frames) at full width, timed; the mini
   fixtures' CFM, joint-VQ and vocoder steps on the card against the CPU
   (losses, gradients with the leaf of the largest difference named,
   updated parameters). ``--only-synthesis-training`` runs phases 1 and 8
   alone, ``--reproduce-synthesis`` phase 1 and the 6,000-step mini recipe
   against ``mini_synth.json``'s recorded eval; neither prints a result;
9. the int8 serving mode and the gateloop regressor: ``cuobjdump -sass`` of
   the built library must show IGMMA (``wgmma``'s integer form) in the int8
   GEMM's functions; the row quantizer and
   the int8 GEMM of ``csrc/int8_gemm.cu`` bit for bit against their plain
   versions at the encoder's four products (M 7,968 and 31,968; K 768 and
   3,072; N 768-3,072), fp32 and bf16, timed (with the TOP/s reached) beside
   the plain versions, the
   bounds, ``torch._int_mm`` + the rescale and the bf16 ``F.linear`` (both
   yardsticks only); both at awkward shapes (K 20, 48, 144, 576, M 1, N 13,
   a strided output); the quantizer on rows whose quotients lie at and next
   to half-integers (``half_integer_rows``), fp32 and bf16, 16-byte and
   scalar loads, K past the register-held width; the GateLoop kernel bit for
   bit against its plain version (the chunked scan) at the regressor's B8
   L265 and B1 L1015, width 512, timed beside its byte bound and its chain
   bounds (the chunked design's and the sequential walk's), and at the
   chunks' edges (``GATELOOP_EDGE_SHAPES``); the full-width Segmenter in
   fp32, bf16 and int8 + bf16 on phase 3's batches (RTFx of five calls,
   launches from 0 with the int8 kernels required, under 1,000 a call, the
   segmentation under ``set_sync_debug_mode("error")``, the per-frame cosine
   of the int8 and bf16 hidden states against fp32); the int8 Segmenter's
   quantizer launches a ``process()`` call: 4 a layer and forward with the
   weights cached, and the weights' quantizations again after a
   ``load_state_dict``; ``mini_ckpt.npz`` int8 + bf16 against
   fp32 exact on the card over phase 4's 18 held-out utterances (boundary F1
   at tolerance 0 at least 0.995) and against int8 on the CPU; the HTTP shim
   with ``--int8``; ``resynthesize`` + ``decode_audio`` at full width on 8 x
   5 s with the gateloop layers off and on (RTFx, launches from 0, the
   GateLoop kernel required). ``--only-int8`` runs phases 1 and 9 alone
   (``--out`` writes phase 9's report) and prints no result;
10. the offline corpus path: both native libraries built by g++
   (``build/native/``, the time printed); ``speechlike.flac`` through the
   native, the pure-Python and (where found) the libsndfile decoder, equal
   samples, ms of the host CPU per audio second each; a seeded corpus of 64
   speechlike utterances of 2-20 s as 16-bit WAV (with libsndfile also as
   FLAC, and ``speechlike.ogg``; without it ``speechlike.flac``), the files
   each decoder read; ``python -m sylber_tpu_torch.segment_corpus`` at full
   width (seeded random weights, bf16, batch 32): the load time apart, the
   stats, the launches of each timed batch (conv0, attention and both
   segmentation passes required), its segments equal to
   ``Segmenter.process`` on the same arrays in the same batches,
   ``--compare`` against its own output 1.0, against an fp32 "highest" run
   printed (no gate); the runner with ``mini_ckpt.npz`` at its width in fp32
   "highest", its segments equal to the CPU port's; ``python -m
   sylber_tpu_torch.precompute_segments`` in the runner's batches, its files
   equal to the runner's frame segments, and with ``--native`` equal to
   them except where the oracle's decision margin is at most 1e-4 (counted);
   ``mini_proof.evaluate`` of ``mini_ckpt.npz`` on the card beside the CPU
   port's and the recorded eval (F1 against the truth within 0.005 of the
   CPU's, fast against exact at least 0.995). ``--only-corpus`` runs phases
   1 and 10 alone; ``--reproduce-distill`` phase 1 and ``mini_ckpt.json``'s
   recipe through ``python -m sylber_tpu_torch.mini_proof`` (F1 against the
   truth at least 0.88, fast against exact at least 0.995); neither prints a
   result;
11. the mesh (``sylber_tpu_torch/parallel``): phase 6's bf16 recipe at
   world size 1 three ways, 13 steps each with cuDNN deterministic: without
   a process group, ``mesh: {dp: 1}`` and ``{dp: 1, fsdp: true}`` over
   NCCL (the step p50 and peak memory of each; the dp run's parameters
   bit-equal to the run without a group, the FSDP run's within 1e-5 of the
   largest); dp=2 and mp=2 on two gloo ranks sharing cuda:0 (full width,
   fp32 "highest", dropout 0, global B8 x 5 s, 3 steps; FSDP too where a
   probe finds gloo's reduce-scatter on CUDA tensors) against one process
   on the same global batch (losses rtol 1e-5, parameters within 1e-6),
   every kernel of the training path launched on every rank; dp=2 over NCCL
   across two cards where the machine has them (step p50, the NCCL
   kernels' share); the ``Segmenter`` over a mesh of two replicas on cuda:0
   on phase 3's batches and a 60 s long-form call (fp32 segments equal,
   bf16 boundary F1 at tolerance 0 at least 0.995; RTFx beside the plain
   Segmenter's, two calls each in turns). Its launches are the
   ``mesh_launches`` of the kernels line. ``--only-mesh`` runs phases 1 and
   11 and prints no result;
12. ``steps_per_dispatch`` (``train/dispatch.py``): phase 6's bf16 recipe
   (B100 x 5 s) with cuDNN deterministic through ``train()`` at K 1 and K
   8, 24 steps each (16 timed): every step's loss, grad norm, norm threshold and
   segment count and the final parameters bit-equal; the step p50 (a
   dispatch's wall over 8, and K 1's per step and per 8 steps), peak
   memory, the capture's seconds, the replays, each kernel's launches in
   the captured step (conv0, small attention and both segmentation passes
   must launch there); one dispatch under ``set_sync_debug_mode("error")``;
   the host's launch calls and the device's idle share in a profiled
   dispatch and a profiled one-step step. Layer 0 at (8, 4) (the
   runtime-shaped kernels) against its plain version on 32 x 80,000, timed
   beside its bound; a full-width ``conv_bias=True`` Segmenter (biases
   drawn non-zero) on 32 x 5 s fp32: conv0's kernel launched, the hidden
   states within 1e-3 of the same Segmenter with layer 0 on the standard
   path (the bias added), the same segments. Phase 7's 8 x 5 s resynthesis
   with the regressor in float32 and in bfloat16 (RTFx, the cosine of the
   outputs), the bf16 GateLoop layers once (the GateLoop kernel must
   launch); both attention kernels at the bf16 regressor's shapes with
   float32 q, k, v (its core) and bf16 ones (not its core), against their
   plain versions and SDPA. Five stage-1 bf16 steps at ``ema_decay`` 0.999
   with and without ``ema_fp32_shadow``: step ms and peak memory.
   ``--only-dispatch`` runs phases 1 and 12 and prints no result.
13. the evaluation entry points, every launch counter from 0 (the
   ``eval_launches`` of the kernels line): the token chain
   (``python -m sylber_tpu_torch.token_chain_proof``'s ``eval_chain``) on the
   recorded v1 codebooks (64, 256, 1,024), 8 held-out utterances of 5 s at 8
   ODE steps, on the card and on the CPU (the same tokens, a token differing
   only at a near-tie; the card's and the CPU's art each within 5e-4 of the
   largest of a float64 reference; conv0, small
   attention and both segmentation passes must launch), its metrics and
   vocoder leg beside the recorded table; ``fit_quantizer`` at full width
   (seeded random weights, bf16) over phase 10's corpus, 5,000 centres and
   a residual codebook (pooled features equal to ``Segmenter.process``'s,
   the seeding kernel launched once a fit; segments a second, fit seconds);
   the vocoder proof for 20 steps against 10 + 10 resumed through its train
   state, cuDNN deterministic (bit-equal parameters; step ms); the demo on
   the mini fixtures (a finite waveform); the seeding kernel at the
   production pool's shape (n 110,109, d 144) at k 5,000, 10,000 and
   20,000, each checked as in phase 8 (the plain version timed at 5,000);
   the bf16 regressor's GateLoop call (casts and the float32 kernel) against
   its plain version, timed beside its bound.
   ``--only-evals`` runs phases 1 and 13 and prints no result;
   ``--only-seeding`` phase 1 and the seeding kernel's records of phases 8
   and 13, and prints no result;
   ``--reproduce-tokens`` phase 1, then the token chains (v1 and rich, on the
   recorded codebooks and refit), the pitch chain and the production
   codebooks, each table beside the recorded one with the JAX package's
   gates; ``--reproduce-vocoder`` the vocoder proofs' recipes (8,000 steps,
   v1 and rich); ``--reproduce-vq`` ``train_synthesis --tokens`` on
   ``configs/sylber_resynthesis_tokens_mini.yaml`` (12,000 steps); 50 steps
   of each training run timed first, the projected wall printed; none
   prints a result.
14. the analyses, every launch counter from 0 around each entry-point call
   on the card (their sum: the ``analysis_launches`` of the kernels line;
   conv0, small attention and both segmentation passes must launch in each
   entry point's calls, flash in the 20 s parity call):
   ``pitch_modulation_ceiling_probe`` (48 utterances) on the card and on the
   CPU (the truth-span ceiling equal, every utterance's segments equal, the
   encoder-segment ceiling within 1e-6); ``pitch_decodability_probe`` for
   ``mini_ckpt.json`` and ``mini_ckpt_rich.json`` at ``--style rich --n 56``
   on both (per-utterance and pooled r within 5e-3: the encoder runs at
   "default", TF32 on the card), beside the recorded r (not gated);
   ``vq_pitch_probe`` on both (the r of probes (a)-(e) within 2e-3, probe
   (f)'s MSE at steps 100 and 600 within 5 % relative: the VQ's argmin may
   flip); ``parity_vs_reference`` on random full-width HuBERT-base weights
   saved as an HF state dict, against HF ``HubertModel`` on the CPU, on
   ``speechlike.wav`` and on a 20 s synthetic utterance (999 frames, the
   flash path): "PARITY OK" (exact segments, hidden states within 1e-3); the
   seeding kernel at d 4,100 (n 512, k 16) and at d 60,000 (n 64, k 8, its
   center past a block's shared memory) against its plain version as in
   phase 8. ``--only-analyses`` runs phases 1 and 14 and prints no result.
15. the JAX trainer's Orbax checkpoints, read with no JAX (``io/zstd.py``'s
   hand-written zstd decoder, ``io/ocdbt.py``, ``io/orbax.py``), on the
   fixtures under ``tests/fixtures/orbax``: the decoder's MB/s of
   decompressed output on the host over ``mini_ckpt_params``' chunks; the
   mini ``Segmenter`` from ``mini_ckpt_params`` against the one from
   ``mini_ckpt.npz`` on 8 x 5 s (segments, features and hidden states
   bit-equal; conv0, small attention and both passes must launch);
   ``SegmentSynthesis`` from ``mini_ckpt_params`` + ``mini_synth_params``
   against the ``.npz`` fixtures, one midpoint resynthesis of 2 x 3 s (art
   and segments bit-equal); the port's trainer resumed from the JAX
   trainer's step 2 (``tiny_train_ckpts``): parameters, EMA, AdamW moments
   and step counts bit-equal to the fixture's arrays, then 3 steps with
   finite losses. Each card call counted from 0; their sum is the
   ``orbax_launches`` of the kernels line. ``--only-orbax`` runs phases 1
   and 15 and prints no result.
16. the port's trainer writing the JAX trainer's Orbax steps
   asynchronously: the full-width stage-2 recipe (phase 6's, bf16, B32 x
   5 s) for 8 steps with ``ckpt_every`` 2 and ``max_to_keep`` 2 in a
   temporary directory; each save's cost on the critical path (the wall of
   the step after it minus the p50 of the other steps), its host copy's ms
   (CUDA events), its background write's seconds and MB/s and the bytes on
   disk; the last step read back through the port's own reader, every leaf
   bit-equal to the live state; a resume from step 6 for 2 steps against
   the uninterrupted run (loss rel 1e-6, parameters atol 1e-6, bit-equality
   reported; cuDNN deterministic in both); the ``Segmenter`` from the
   written ``params_final/`` against the one from ``params_final.npz`` on
   4 x 5 s (segments, features and hidden states bit-equal). The trainer's
   and the Segmenter's card calls each counted from 0 (conv0, small
   attention and both passes must launch); their sum is the
   ``orbax_write_launches`` of the kernels line. ``--only-orbax-write``
   runs phases 1 and 16 and prints no result.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
(``nvidia-smi``), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
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
# fp32 CUDA cores; bf16 and int8 tensor cores (dense)
H100_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# Least dependent latency of one frame of the pass-1 scan, in SM cycles, from
# assumed (not measured) instruction latencies: 4 for a dependent fp32 add,
# multiply or FMA, 24 for a warp shuffle, 40 for an IEEE square root or
# division. One product (4), a reduction across a warp's lanes (5 x (24 + 4)),
# the square root of |curr|^2 (40), two divisions (80), compare and select
# (8), the update of the mean (4 + 4 + 40).
PASS1_CHAIN_CYCLES = 4 + 5 * (24 + 4) + 40 + 80 + 8 + 48


def pass2_chain_cycles(d: int) -> int:
    """Least dependent latency of one link of a pass-2 chain (a mid boundary
    that reads the segment the one before left), in SM cycles, on the same
    assumed latencies, for a lane holding d / 32 elements of a row: the means
    (a subtraction and a division, 4 + 40), the lane's products (4 each),
    a 5-step warp reduction of dot, |a|^2 and |b|^2, two square roots and two
    divisions, the compare (8); then the least window's (2 frames): the
    lane's products, a 5-step reduction, a frame's cosine (a product and a
    division), and the walk of 2 frames (two passes of an add, a compare and a
    select, 16 each)."""
    lane = -(-d // 32) * 4
    return (44 + lane + 5 * (24 + 4) + 80 + 80 + 8) + (lane + 5 * (24 + 4) + 44 + 2 * 16)
# phase 2's record of flash attention at the long-form windows' shape
LONGFORM_FLASH = "flash_attention_B8_L1549"
# phase 2's segmentation cases at the consumers' shapes: a long-form window
# batch and a streaming hop
CONSUMER_SEGMENTATION = ("longform_B8_L1549", "streaming_B1_L199")
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
    p1e = seg.segment_pass1(states, voiced, thr)  # equal to the plain version's, see above
    return p1, {"float32": pass2_record(torch, seg, states, norms, p1e, thr)}


def pass2_record(torch, seg, states, norms, p1, thr):
    """Pass 2 + compaction on pass 1's buffers ``p1``: segments and counts
    against the plain version (0 mismatches), times, the byte bound and the
    chain bound (the longest chain of mid boundaries, link by link)."""
    B, L, d = states.shape
    P = seg._prefix_sums(states)
    args = (states, norms, P, p1.segs, p1.nseg, p1.mids, p1.nmid, thr)
    run = lambda: seg.segment_pass2(*args)  # noqa: E731
    plain = lambda: seg.segment_pass2_plain(*args)  # noqa: E731
    (got_segs, got_n), (want_segs, want_n) = run(), plain()
    mism = int((got_segs != want_segs).sum().item() + (got_n != want_n).sum().item())
    p_rows, win_frames = pass2_traffic(*(a.cpu().numpy() for a in args[:1] + args[3:7]), thr)
    chains = chain_counts(*(t.cpu().numpy() for t in (p1.mids, p1.nseg, p1.nmid)))
    nbytes = (4 * d * (p_rows + win_frames) + 4 * win_frames       # rows of P and states, norms
              + 2 * 8 * B * (L + 1) + 2 * 4 * B                   # segs, mids, nseg, nmid
              + 8 * B * (L + 1) + 4 * B)                          # segments, counts
    b_ms, b_by = bound_ms(nbytes, 2.5 * d * p_rows + 4.0 * d * win_frames, "float32")
    return dict(
        max_abs_err=float(mism), tol=0, ok=mism == 0, ms=graph_time_ms(torch, run, 5),
        eager_ms=time_ms(torch, run, 10),
        plain_ms=time_ms(torch, plain, 1, warmup=0), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, shape=[B, L, d],
        mid_boundaries=int(p1.nmid.sum().item()), segments=int(got_n.sum().item()),
        p_rows_read=p_rows, window_frames=win_frames, chains=chains["chains"],
        longest_chain=chains["longest_chain"],
        chain_bound_ms=chains["longest_chain"] * pass2_chain_cycles(d) / sm_clock_hz() * 1e3)


def log_pass2(label, r, smi):
    log(f"{label}: segment_pass2 {r['shape']}: {r['max_abs_err']:.0f} mismatches ok={r['ok']}  "
        f"kernel_ms {r['ms']:.4f} (eager {r['eager_ms']:.4f})  plain_ms {r['plain_ms']:.3f}  "
        f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})  chain_bound_ms "
        f"{r['chain_bound_ms']:.4f}; {r['mid_boundaries']} mid boundaries in {r['chains']} "
        f"chains, longest_chain {r['longest_chain']}; read {r['p_rows_read']} rows of prefix "
        f"sums and {r['window_frames']} window frames, left {r['segments']} segments  [{smi}]")


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
    """What pass 2 must do for this data, walked on the host in numpy as the
    oracle of the JAX package walks it: the rows of the prefix sums it reads
    (4 per mid boundary it looks at) and the window frames of its sweeps."""
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
            prev_c, nxt = cos(states[b, ws:we], mean_a), cos(states[b, ws:we], mean_b)
            opt = ws + int(np.argmax([prev_c[:j].sum() + nxt[j:].sum() for j in range(we - ws)]))
            row[gi], row[gi + 1] = [a0, opt], [opt, b1]
    return int(p_rows), int(win_frames)


def chain_counts(mids, nseg, nmid):
    """The chains of mid boundaries in pass 1's buffers (numpy): a boundary
    continues a chain when its segment index is the previous boundary's + 1
    (it reads the segment that one left), and one whose segment is the last
    is skipped. Their number, the longest, the boundaries, and the most in a
    row."""
    chains, longest = 0, 0
    for b in range(len(nmid)):
        prev, length = None, 0
        for _, gi in mids[b, :nmid[b]]:
            if gi >= nseg[b] - 1:
                prev = None
                continue
            if prev is None or gi != prev + 1:
                chains, length = chains + 1, 0
            prev, length = gi, length + 1
            longest = max(longest, length)
    return dict(chains=int(chains), longest_chain=int(longest),
                mid_boundaries=int(nmid.sum()), most_in_a_row=int(nmid.max()) if len(nmid) else 0)


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
             ("d1024", rows(2, 300, 1024), None), ("d50", rows(3, 300, 50), None),
             # sums of frames past 2^60: pass 2 takes its means' IEEE fallback
             ("huge_values", rows(2, 300, 16) * np.float32(1e17), None)]
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
        rec = dict(case=name, shape=list(states.shape), mismatches=mism,
                   feature_err=err, ok=mism == 0 and err <= 1e-5, launches=launches,
                   segments=got.num_segments.tolist())
        if name in CONSUMER_SEGMENTATION:  # pass 2 timed there, beside its bounds
            voiced = ((got.norms >= 2.6) & fv).contiguous()
            rec["pass2"] = pass2_record(torch, seg, x, got.norms,
                                        seg.segment_pass1(x, voiced, 0.8), 0.8)
            rec["ok"] = rec["ok"] and rec["pass2"]["ok"]
        records.append(rec)
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
    events' intervals, so events that overlap (on other streams) count once;
    ``kernel_busy_ms`` the same without the copies and memsets (whose
    pageable host copies vary by run), ``nccl_busy_ms`` the same over NCCL's
    kernels alone. ``device_sum_ms`` is the plain sum of
    their durations, ``overlap_ms`` the difference, and ``duplicate_events``
    the events that share a name and a start with another (events the
    profiler reported twice)."""
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

    def busy_us(events):
        total, reach = 0.0, float("-inf")
        for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = {k[:70]: v for k, v in ranked
            if any(tag in k for tag in ("sylber", "conv0_", "segment_pass"))}
    total = sum(by_name.values())
    busy = busy_us(kernels) / 1e3
    work = [e for e in kernels if not e.name.startswith(("Memcpy", "Memset"))]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return dict(wall_ms=wall * 1e3, device_ms=busy, kernel_busy_ms=busy_us(work) / 1e3,
                nccl_busy_ms=busy_us(nccl) / 1e3,
                device_sum_ms=total, overlap_ms=total - busy,
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


def main_path(torch, Segmenter, HubertConfig, counters, modes=None, label="main path"):
    """Each mode's Segmenter (default: fp32 parity and bf16 fast) on the
    32 x 5 s and 32 x 12-20 s batches: a warm-up, five timed calls, a
    profiled one, with ``counters`` from 0. Returns the runs, the launches
    and every item's hidden states by (mode, batch)."""
    rng = np.random.RandomState(1)
    batches = {
        "small_32x5s": [speechlike(rng, 5 * 16000) for _ in range(32)],
        "flash_32x12-20s": [speechlike(rng, int(rng.uniform(12, 20) * 16000))
                            for _ in range(32)],
    }
    modes = modes or {
        "fp32_highest": HubertConfig(),
        "bf16_default": HubertConfig(dtype="bfloat16", frontend_dtype="bfloat16",
                                     precision="default"),
    }
    runs, hidden = [], {}
    for fn in counters:
        fn.launches = 0
    for mode, cfg in modes.items():
        seg = Segmenter(hubert_config=cfg)
        thresholds = (seg.norm_threshold, seg.merge_threshold)
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
            hidden[(mode, bname)] = [o["hidden_states"] for o in outs]
            runs.append(dict(mode=mode, batch=bname, audio_s=audio_s, wall_s=walls,
                             rtfx=rtfx[2], rtfx_min=rtfx[0], rtfx_max=rtfx[-1],
                             segments=int(sum(len(o["segments"]) for o in outs)),
                             profile=profile(torch, lambda: seg.process(wavs))))
            prof = runs[-1]["profile"]
            log(f"{label} {mode} {bname}: {audio_s:.1f} s audio, 5 timed calls: RTFx median "
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
    for run in runs:  # after the counts: the plain pass 1 launches no kernel of the port
        run["pass2_chains"] = hidden_chains(torch, hidden[(run["mode"], run["batch"])],
                                            *thresholds)
        c = run["pass2_chains"]
        log(f"{label} {run['mode']} {run['batch']}: pass 2 meets {c['mid_boundaries']} mid "
            f"boundaries in {c['chains']} chains, the longest {c['longest_chain']} links "
            f"(at most {c['most_in_a_row']} boundaries in a row; voiced frames "
            f"{c['voiced_share']:.4f} of the valid ones)")
    for bname in batches:
        for mode in modes:
            if mode != "fp32_highest" and ("fp32_highest", bname) in hidden:
                a, b = hidden[("fp32_highest", bname)][0], hidden[(mode, bname)][0]
                log(f"{mode} vs fp32 hidden, {bname}: max abs diff {np.abs(a - b).max():.4g}")
    return runs, launches, hidden


def hidden_chains(torch, hidden, norm_threshold, merge_threshold):
    """The chains of mid boundaries that pass 2 meets on a batch of returned
    hidden states (numpy, one (T, d) array an item), from the plain pass 1
    on the card, padded as ``segment_batch`` pads."""
    from sylber_tpu_torch.ops import segment as seg

    L = max(len(h) for h in hidden)
    x = np.zeros((len(hidden), L, hidden[0].shape[1]), np.float32)
    valid = np.zeros((len(hidden), L), bool)
    for b, h in enumerate(hidden):
        x[b, :len(h)], valid[b, :len(h)] = h, True
    x, valid = torch.from_numpy(x).cuda(), torch.from_numpy(valid).cuda()
    voiced = (seg.frame_norms(x) >= norm_threshold) & valid
    p1 = seg.segment_pass1_plain(x, voiced, merge_threshold)
    out = chain_counts(*(t.cpu().numpy() for t in (p1.mids, p1.nseg, p1.nmid)))
    out["voiced_share"] = float(voiced.sum().item() / valid.sum().item())
    return out


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


def http_shim(codebook, device, mode="--bf16"):
    """Start ``python -m sylber_tpu_torch.serve_http`` on a free port (``mode``
    ``--bf16`` or ``--int8``, seeded random weights, ``codebook`` for
    /tokenize), send it one int16 body on /segment, /tokenize and
    /resynthesize, read /stats, stop it. Without a codebook /tokenize must
    answer 503."""
    import urllib.error
    import urllib.request

    out_dir = ROOT / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    args = [sys.executable, "-m", "sylber_tpu_torch.serve_http", "--device", device, mode,
            "--no-warmup", "--port", "0"]
    if codebook is not None:
        np.save(out_dir / "codebook_10000.npy", codebook)
        args += ["--centroids", str(out_dir / "codebook_10000.npy")]
    proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
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
    log(f"{'phase 5' if mode == '--bf16' else 'phase 9'} HTTP shim (python -m "
        f"sylber_tpu_torch.serve_http --device {device} {mode}, up in "
        f"{started:.1f} s): /segment {codes['segment']} ({seg.get('num_segments')} segments), "
        f"/tokenize {codes['tokenize']} ({len(tok.get('tokens', []))} tokens), /resynthesize "
        f"{codes['resynthesize']}, /stats {codes['stats']} ({stats['completed']} completed)")
    tokenized = codebook is None or seg["num_segments"] == len(tok["tokens"])
    if (codes != {"segment": 200, "tokenize": 200 if codebook is not None else 503,
                  "resynthesize": 503, "stats": 200}
            or not tokenized or not seg["num_segments"]):
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


def training_run(torch, counters, label, recipe, out_dir, smi, steps=13, warm=3,
                 profile_steps=None):
    """``train()`` for ``steps`` steps (every launch counter from 0, metrics
    fetched every step), then on the state it returns: one step under
    ``set_sync_debug_mode("error")`` with its launches, one profiled step and
    one step in parts. With ``profile_steps=(a, b)`` the run traces steps a
    to b (0-based) into ``<out_dir>/profile/trace.json``, which must name the
    port's kernels; the timed steps then start after b + 1 (the trace's
    export lands in step b's time)."""
    from sylber_tpu_torch.train.distill import make_train_step
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train, train_batches
    from sylber_tpu_torch.utils.profiling import hubert_train_flops, mfu

    B = recipe["data"]["batch_size"]
    for fn in counters:
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if profile_steps:
        steps, warm = steps + profile_steps[1] + 1 - warm, profile_steps[1] + 1
    state = train(recipe, out_dir=str(out_dir), max_steps=steps, log_every=1, ckpt_every=0,
                  device="cuda", profile_steps=profile_steps)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    trace = None
    if profile_steps:
        path = Path(out_dir) / "profile" / "trace.json"
        events = json.loads(path.read_text())["traceEvents"]
        ours = sorted({e["name"][:60] for e in events
                       if any(t in e.get("name", "") for t in ("sylber", "conv0_",
                                                                 "segment_pass"))})
        trace = dict(steps=list(profile_steps), path=str(path.relative_to(out_dir)),
                     bytes=path.stat().st_size, events=len(events),
                     kernel_events=sum(e.get("cat") == "kernel" for e in events),
                     port_kernels=ours)
        log(f"phase 6 {label}: train(profile_steps={tuple(profile_steps)}) wrote "
            f"{trace['path']} ({trace['bytes'] / 1e6:.1f} MB, {trace['events']} events, "
            f"{trace['kernel_events']} kernels); the port's kernels in it: {ours}")
        if not ours:
            raise AssertionError(f"{label}: the trace names none of the port's kernels")
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
               profile=prof, parts_ms=parts, trace=trace, losses=[r["loss"] for r in rows],
               num_segments=[r["num_segments"] for r in rows])
    log(f"phase 6 {label}: B{B} x {crop} samples, remat {rec['remat']}: step p50 "
        f"{p50:.1f} ms ({len(step_ms)} steps after {warm} untimed, min {min(step_ms):.1f}, max "
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
    gap = gradient_gap(g["grads"], c["grads"])
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    rec = dict(loss_cuda=g["loss"], loss_cpu=c["loss"], loss_rel_err=rel, segments_equal=same,
               segments=int(c["num_segments"].sum()), grad_max_abs_err=gerr,
               grad_largest=largest, grad_gap=gap,
               ok=bool(rel <= 1e-4 and same and gerr <= 1e-4 * largest
                       and g["grads"].keys() == c["grads"].keys()))
    log(f"phase 6 card vs CPU, one stage-2 step of mini_ckpt.npz (B4 x 3 s, fp32 highest): loss "
        f"{g['loss']:.6g} vs {c['loss']:.6g} (rel {rel:.2g}, tol 1e-4), segments equal {same} "
        f"({rec['segments']}), max |grad diff| {gerr:.3g} of largest {largest:.3g} (tol 1e-4 "
        f"relative) ok={rec['ok']}")
    log(f"phase 6 card vs CPU gradients: the largest difference is in {gap['leaf']} "
        f"({gap['rel']:.3g} of the largest gradient, {gap['leaf_own_rel']:.3g} of the leaf's "
        f"own largest); next: " + ", ".join(f"{k} {e:.3g}" for k, e in gap["top"][1:]))
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
    log_pass2("phase 6 (the trainer's shape)", shapes["segment_pass2"]["float32"], smi)
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
                         stage2_recipe("bfloat16", "default", 100), tmp / "bf16", smi,
                         profile_steps=(3, 5)),
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
    """(wav, art) utterances of the trainers' synthesis corpus."""
    from sylber_tpu_torch.train.synthesis_loop import build_synthesis_corpus

    corpus = build_synthesis_corpus(n, seconds, seed, style)
    return corpus["wav"], corpus["art"]


def rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def segment_tokens(torch, synth, wav, nt):
    """The tokens and features of a wav batch's valid segments, (n, codes)
    and (n, d) on the host, and each utterance's count of segments (B,), as
    the wav path computes them (the quantizer takes the whole (B, MS, d)
    batch: the distance matmul's shape sets its rounding)."""
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
            np.concatenate([feats[b, :n[b]] for b in range(len(n))]), n)


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
    (tg, _, _), (tc, fc, _) = (segment_tokens(torch, s, wav, nt) for s in (gpu, cpu))
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


# ---------------------------------------------------------------- phase 8

# a seeding row may differ from the plain version's only where the uniform
# lands within this share of the total weight of a prefix boundary: the two
# sum each squared distance in float32 in their own order, so the weights,
# and with them the float64 prefixes, round apart by at most about 1e-7 of
# the total; ten times that, well below the 1.5e-5 of the total that the
# average row holds at n 65,536, so that taking a neighbouring row fails
KMEANSPP_TIE_RTOL = 1e-6
KMEANSPP_SHAPES = [  # name, rows, width, centers, distinct points (each repeated) or None
    ("mini", 4096, 144, (64, 256, 1024), None),
    ("vq_art", 4096, 24, (256,), None),
    ("vq_pitch", 4096, 8, (64,), None),
    ("awkward_rows", 5003, 144, (128,), None),
    ("duplicates", 4096, 144, (256,), 256),
    ("full_width", 65536, 768, (2000,), None),
    ("fit_pool", 65536, 144, (5000, 10000, 20000), None),  # fit_kmeans's pool at the codebooks' d
]
# the mini card-vs-CPU checks (as the CPU tests hold the port to JAX):
# losses within 1e-4, gradients within 1e-4 of the largest, updated
# parameters within 1e-5. The vocoder's generator gradient is ill-conditioned
# in float32 (a leaky ReLU pre-activation within rounding of 0 takes the other
# slope on the other device), so the whole vocoder step is held to these
# gates in float64, and in float32 its losses and the discriminators'
# gradients are; there a discriminator element may sit more than 1e-5 apart
# only where its gradient lies within the gradients' largest difference of 0
# (Adam's first step moves it by about +-lr, the sign of its gradient)
SYNTH_GRAD_RTOL, SYNTH_LOSS_RTOL, SYNTH_PARAM_ATOL = 1e-4, 1e-4, 1e-5
FULL_CFM_UTTS = 128  # of the recipe's 512: the batch is 64, the corpus is built on the host


def gradient_gap(got, want):
    """The largest difference between two ``{leaf: gradient}`` dicts,
    relative to ``want``'s largest gradient, with the leaf that sets it
    (also relative to that leaf's own largest) and the next four; and the
    trees' L2 difference relative to ``want``'s L2 norm."""
    largest = max(float(v.abs().max()) for v in want.values())
    per = {k: float((got[k].float() - v.float()).abs().max()) for k, v in want.items()}
    worst = max(per, key=per.get)
    l2 = sum(float(((got[k].double() - v.double()) ** 2).sum()) for k, v in want.items())
    norm = sum(float((v.double() ** 2).sum()) for v in want.values())
    return dict(rel=per[worst] / largest, leaf=worst, leaf_abs=per[worst],
                leaf_own_rel=per[worst] / max(float(want[worst].abs().max()), 1e-30),
                largest=largest, l2_rel=(l2 / max(norm, 1e-300)) ** 0.5,
                top=[(k, e / largest) for k, e in sorted(per.items(), key=lambda kv: -kv[1])[:5]])


def mixture(torch, n, d, seed, clusters=64):
    """Seeded clustered points (n, d) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    means = torch.randn(clusters, d, generator=g, device="cuda") * 3
    pick = torch.randint(0, clusters, (n,), generator=g, device="cuda")
    return means[pick] + torch.randn(n, d, generator=g, device="cuda")


def kmeanspp_replay(torch, km, x, u, rows):
    """The plain steps replayed on the kernel's rows, on the card without a
    host read: for each step whose row differs from the plain draw, the gap
    between the target and the nearest prefix between the two rows, as a
    share of the total (float64 on the host; inf where the rows agree)."""
    n, k = x.shape[0], u.shape[0]
    gaps = torch.full((k,), float("inf"), dtype=torch.float64, device=x.device)
    first = min(int(np.floor(float(u[0]) * n)), n - 1)
    if first != int(rows[0]):
        gaps[0] = 1.0
    ar = torch.arange(n, device=x.device)
    d2 = None
    for j in range(1, k):
        dist = ((x - x.index_select(0, rows[j - 1:j])) ** 2).sum(-1)
        d2 = dist if d2 is None else torch.minimum(d2, dist)
        cum = torch.cumsum(d2.clamp_min(km.MIN_WEIGHT).double(), 0)
        target = u[j] * cum[-1]
        p = torch.searchsorted(cum, target[None], right=True).clamp_max(n - 1)
        lo, hi = torch.minimum(p, rows[j:j + 1]), torch.maximum(p, rows[j:j + 1])
        between = (ar >= lo) & (ar < hi)
        gaps[j] = torch.where(between, (cum - target).abs(), np.inf).min() / cum[-1]
    gaps = gaps.cpu().numpy()
    return gaps[np.isfinite(gaps)]


def seeding_launches(torch, km, x, u, tries=6):
    """The launches of one ``kmeanspp`` call: the wrapper's count (it counts
    where it launches the kernel), and from the profiler the seeding
    kernel's launches and every device event (the scratch's zeroing too),
    the most that any profiled call saw (the profiler can lose a call's
    device events, late in the whole script all of them, and never adds one;
    up to ``tries`` calls, until one shows the kernel)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    seeding, events, calls = 0, 0, 0
    before = km.kmeanspp.launches
    while calls < tries and not seeding:
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            km.kmeanspp(x, u)
            torch.cuda.synchronize()
        calls += 1
        cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seeding = max(seeding, sum("kmeanspp_seed" in e.name for e in cuda))
        events = max(events, len(cuda))
    return dict(kernel_launches=seeding, device_events=events, profiled_calls=calls,
                wrapper_launches=(km.kmeanspp.launches - before) / calls)


def exchange_round_trip_ms(torch, km, n, d, steps):
    """The round trip of the seeding kernel's exchange of every block's sum
    to every block (its grid barrier) on its grid for (n, d): a launch of
    ``steps`` exchange-only steps, timed, over ``steps``."""
    return time_ms(torch, lambda: km.kmeanspp_barrier_probe(n, d, steps), reps=3,
                   warmup=1) / steps


def resident_rows(n, plan):
    """The rows of x that the grid's shared memory holds for a plan."""
    g, r, res = plan["grid"], plan["rows_per_block"], plan["resident_rows_per_block"]
    return sum(min(res, n - b * r) for b in range(g))


def kmeanspp_bounds(n, d, k, plan, round_trip_ms):
    """The seeding's bounds for a plan: x from device memory each step (the
    two-launch design's), the on-chip bytes (x read once, then the rows that
    do not fit the grid's shared memory once a step, the centers and rows
    written) against the operations (3 n d a step), the chain ((k - 1) steps
    of two grid-wide exchanges, each at least the exchange's round trip), and
    the function's own (every input read once, every output written once)."""
    ops = 3.0 * n * d * (k - 1)
    out_bytes = k * d * 4.0 + k * 4.0
    spill = (n - resident_rows(n, plan)) * d * 4.0
    onchip, onchip_by = bound_ms(n * d * 4.0 + (k - 1) * spill + out_bytes + k * 8.0, ops,
                                 "float32")
    chain = (k - 1) * 2 * round_trip_ms
    once, once_by = bound_ms(n * d * 4.0 + k * 8.0 + out_bytes, ops, "float32")
    each_step, _ = bound_ms((k - 1) * n * d * 4.0 + out_bytes, ops, "float32")
    governing, by = (onchip, onchip_by) if onchip >= chain else (chain, "chain")
    return dict(bound_ms=governing, bound_by=by, onchip_bound_ms=onchip, onchip_bound_by=onchip_by,
                chain_bound_ms=chain, exchange_round_trip_us=round_trip_ms * 1e3,
                inputs_once_bound_ms=once, inputs_once_bound_by=once_by,
                x_each_step_bound_ms=each_step, resident_share=resident_rows(n, plan) / n)


def kmeanspp_record(torch, km, name, x, k, seed, distinct=None, time_plain=True):
    """The seeding kernel against its plain version at one shape: the plain
    steps replayed on the kernel's rows, a differing row allowed only at a
    tie (KMEANSPP_TIE_RTOL), the centers against the rows they copy, a
    second call's rows identical, the launches of one call (the seeding
    kernel once); kernel, plain and exchange times, the plan and the bounds."""
    n, d = x.shape
    u = km.seeding_uniforms(seed, k).cuda()
    centers, rows = km.kmeanspp(x, u)
    again, again_rows = km.kmeanspp(x, u)
    torch.cuda.synchronize()
    copy_err = float((centers - x.index_select(0, rows)).abs().max())
    identical = bool(torch.equal(rows, again_rows) and torch.equal(centers, again))
    gaps = kmeanspp_replay(torch, km, x, u, rows)
    bad = int((gaps > KMEANSPP_TIE_RTOL).sum())
    distinct_ok = None
    if distinct:
        distinct_ok = len({tuple(r) for r in centers.cpu().numpy().tolist()}) == distinct
    launches = seeding_launches(torch, km, x, u)
    ms = time_ms(torch, lambda: km.kmeanspp(x, u), reps=3, warmup=1)
    plain_ms = (time_ms(torch, lambda: km.kmeanspp_plain(x, u), reps=1, warmup=1)
                if time_plain else None)
    plan = km.seeding_plan(n, d)
    bounds = kmeanspp_bounds(n, d, k, plan, exchange_round_trip_ms(torch, km, n, d, k))
    ok = (bad == 0 and copy_err == 0.0 and distinct_ok is not False and identical
          and launches["wrapper_launches"] == 1 and launches["kernel_launches"] <= 1)
    return dict(name=name, shape=[n, d, k], ties=len(gaps),
                worst_tie_gap=float(gaps.max(initial=0.0)), non_tie_differences=bad,
                max_abs_err=copy_err, distinct_ok=distinct_ok, identical_rows=identical, ms=ms,
                us_a_step=ms * 1e3 / max(k - 1, 1), plain_ms=plain_ms, plan=plan, **bounds,
                cuda_launches_per_call=launches["wrapper_launches"],
                profiler_kernel_launches=launches["kernel_launches"],
                device_events_per_call=launches["device_events"], ok=bool(ok))


def log_seeding(phase, r, smi):
    plain = f"{r['plain_ms']:.3f}" if r["plain_ms"] is not None else "not timed"
    log(f"{phase}: kmeanspp {r['name']} {r['shape']} (n, d, k): {r['ties']} tie(s) (worst gap "
        f"{r['worst_tie_gap']:.2g} of the total, tol {KMEANSPP_TIE_RTOL}), "
        f"{r['non_tie_differences']} other differences, copy err {r['max_abs_err']}, distinct "
        f"{r['distinct_ok']}, identical rows on two calls {r['identical_rows']} ok={r['ok']}  "
        f"kernel_ms {r['ms']:.3f} ({r['us_a_step']:.2f} us a step)  plain_ms {plain}  "
        f"grid {r['plan']['grid']} x {r['plan']['rows_per_block']} rows ({r['plan']['threads']} "
        f"threads), resident share "
        f"{r['resident_share']:.3f}, exchange round trip {r['exchange_round_trip_us']:.3f} us  "
        f"bound_ms {r['bound_ms']:.3f} ({r['bound_by']}; on-chip {r['onchip_bound_ms']:.3f} "
        f"({r['onchip_bound_by']}, {r['ms'] / r['onchip_bound_ms']:.2f}x), chain "
        f"{r['chain_bound_ms']:.3f} ({r['ms'] / r['chain_bound_ms']:.2f}x); x each step "
        f"{r['x_each_step_bound_ms']:.3f}; inputs once {r['inputs_once_bound_ms']:.4f})  "
        f"{r['cuda_launches_per_call']:g} launch(es) a call (the profiler saw "
        f"{r['profiler_kernel_launches']} of the kernel and {r['device_events_per_call']} device "
        f"events)  [{smi}]")


def kmeanspp_records(torch, km, smi, phase="phase 8"):
    recs = []
    for name, n, d, ks, distinct in KMEANSPP_SHAPES:
        if distinct:
            pts = mixture(torch, distinct, d, seed=n + d)
            x = pts[torch.randperm(n, generator=torch.Generator().manual_seed(1)).cuda()
                    % distinct].contiguous()
        else:
            x = mixture(torch, n, d, seed=n + d)
        for i, k in enumerate(ks):
            recs.append(kmeanspp_record(torch, km, name, x, k, seed=k, distinct=distinct,
                                        time_plain=i == 0 or n <= 4096))
            log_seeding(phase, recs[-1], smi)
        del x
    return recs


def fit_kmeans_run(torch, km, smi):
    """``fit_kmeans`` at 5,000 centers on 65,536 x 768 seeded features, the
    seeding's launches counted from 0: the kmeanspp kernel's main path."""
    feats = mixture(torch, 65536, 768, seed=7, clusters=2000).cpu().numpy()
    km.kmeanspp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centroids, inertia = km.fit_kmeans(feats, 5000, seed=0, device="cuda")
    wall = (time.perf_counter() - t0) * 1e3
    launches = km.kmeanspp.launches
    ok = (centroids.shape == (5000, 768) and np.isfinite(centroids).all()
          and np.isfinite(inertia) and launches >= 1)
    rec = dict(shape=[65536, 768, 5000], ms=wall, inertia=inertia, kmeanspp_launches=launches,
               ok=bool(ok))
    log(f"phase 8: fit_kmeans 65,536 x 768 -> 5,000 centers (10 epochs of batch 16,384): "
        f"{wall:.1f} ms, inertia {inertia:.4g}, kmeanspp launched {launches} time(s) "
        f"ok={rec['ok']}  [{smi}]")
    return rec


def _quiet_setup(SL, cfg, device):
    import warnings

    with warnings.catch_warnings():  # no speech_model_ckpt: a seeded random encoder
        warnings.simplefilter("ignore")
        return SL.setup(cfg, 0, device)


def cfm_step_parts_ms(torch, synth, state, batch, opt):
    """One CFM step in parts (CUDA events): the forward (conditioning, the
    regressor, the loss), the backward, the clip + AdamW update."""
    from sylber_tpu_torch.flow.cfm import cfm_draws
    from sylber_tpu_torch.models.hubert import matmul_precision
    from sylber_tpu_torch.train.distill import apply_gradients, step_generators

    gens = step_generators(0, state.step, "cuda")
    draws = cfm_draws(batch["art"].shape, gens.noise, gens.mask, gens.drop, "cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in state.params:
        p.grad = None
    for m in synth.trainable_modules():
        m.train()
    with matmul_precision(synth.config.regressor.precision):
        ev[0].record()
        loss = synth.loss(batch, draws)
        ev[1].record()
        loss.backward()
        ev[2].record()
        apply_gradients(state.params, [p.grad for p in state.params], state.optimizer, None,
                        state.step, opt, opt.schedule())
        ev[3].record()
    for m in synth.trainable_modules():
        m.eval()
    torch.cuda.synchronize()
    return {k: ev[i].elapsed_time(ev[i + 1])
            for i, k in enumerate(("forward", "backward", "optimizer"))}


def full_cfm_runs(torch, counters, smi, tmp):
    """``train_synthesis`` at full width (``configs/sylber_resynthesis.yaml``,
    seeded random encoder, the synthetic corpus of FULL_CFM_UTTS utterances)
    under "highest" and "default": 13 steps with every launch counter from 0
    (the precompute runs conv0, small attention and both segmentation
    passes; the held-out gate small attention), the step p50 of the last 10,
    frames a second, the step's FLOPs (FlopCounterMode) and MFU, peak
    memory; then on the trained model one step under
    ``set_sync_debug_mode("error")``, a profiled step and
    ``evaluate_synthesis`` on 8 held-out utterances with the counters from 0."""
    import dataclasses

    import yaml
    from torch.utils.flop_counter import FlopCounterMode

    from sylber_tpu_torch.synthesis import make_synthesis_optimizer, make_synthesis_train_step
    from sylber_tpu_torch.train import synthesis_loop as SL
    from sylber_tpu_torch.utils.profiling import peak_flops

    base = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    base["data"]["n_utts"] = FULL_CFM_UTTS
    base["eval"]["n_utts"] = 8
    runs = {}
    for precision in ("highest", "default"):
        cfg = json.loads(json.dumps(base))
        cfg["regressor_configs"]["precision"] = precision
        out = Path(tmp) / f"cfm_{precision}"
        for fn in counters:
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            state, ev = SL.train_synthesis(cfg, out_dir=str(out), max_steps=13, log_every=1,
                                           eval_steps=10, device="cuda")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()
        idle = [k for k in ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2")
                if launches[k] == 0]
        if idle:
            raise AssertionError(f"phase 8 {precision}: kernels never launched: {idle}")
        rows = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
        train_rows = [r for r in rows if r["prefix"] == "train"]
        if len(train_rows) != 13 or not all(np.isfinite(r["cfm_loss"]) for r in train_rows):
            raise AssertionError(f"phase 8 {precision}: metrics {train_rows[:2]}")
        step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(train_rows, train_rows[1:])][2:]
        p50 = float(np.median(step_ms))

        synth = state.synth
        B = base["train"]["batch_size"]
        corpus = SL.build_synthesis_corpus(B, 5.0, seed=3)
        nt = synth.default_normthreshold
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _ = SL.corpus_features(synth, synth.config, corpus, nt, 0.8)
        torch.cuda.synchronize()
        precompute_ms = (time.perf_counter() - t0) * 1e3
        batch = {"features": feats, "art": torch.from_numpy(corpus["art"]).cuda()}
        opt = make_synthesis_optimizer(lr=1e-4, warmup_steps=5000, total_steps=500000)
        state.step = 13
        step_fn = make_synthesis_train_step(synth, opt)
        with FlopCounterMode(display=False) as fc:
            step_fn(state, batch, 0)
        flops = float(fc.get_total_flops())
        torch.cuda.synchronize()
        forbid_host_syncs(torch, step_fn)(state, batch, 0)  # raises on a host sync
        torch.cuda.synchronize()
        prof = profile(torch, lambda: step_fn(state, batch, 0), top=8)
        parts = cfm_step_parts_ms(torch, synth, state, batch, opt)
        frames = B * feats.shape[1]
        rec = dict(precision=precision, batch=B, frames=int(feats.shape[1]), step_ms=step_ms,
                   step_ms_p50=p50, frames_per_s=frames / (p50 / 1e3), step_tflop=flops / 1e12,
                   mfu=flops / (p50 / 1e3) / peak_flops("float32", precision),
                   max_memory_allocated_gb=peak / 1e9, launches_over_run=launches,
                   losses=[r["cfm_loss"] for r in train_rows], train_eval=ev, profile=prof,
                   parts_ms=parts, precompute_ms_64_utts=precompute_ms)
        log(f"phase 8 CFM {precision}: B{B} x {rec['frames']} frames (regressor depth 8, 512 "
            f"wide): step p50 {p50:.1f} ms (10 steps after 3 warm-up, min {min(step_ms):.1f}, "
            f"max {max(step_ms):.1f}), {rec['frames_per_s']:.0f} frames/s, {flops / 1e12:.2f} "
            f"TFLOP a step, MFU {100 * rec['mfu']:.1f} % of the fp32 {precision} peak, "
            f"max_memory_allocated {peak / 1e9:.2f} GB; loss {rec['losses'][0]:.4g} -> "
            f"{rec['losses'][-1]:.4g}; launches over the run {launches}  [{smi}]")
        log(f"phase 8 CFM {precision}: one step under set_sync_debug_mode('error'): no host "
            f"sync; profiled step: device busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} "
            f"ms, {prof['launches']} launches; top: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["top_ms"]))
        log(f"phase 8 CFM {precision}: a step in parts (CUDA events): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
            + f"; precompute of 64 x 5 s (encoder, both segmentation passes, the fill) "
            f"{precompute_ms:.1f} ms  [{smi}]")

        heldout = SL.build_synthesis_corpus(8, 5.0, seed=90001)
        feats_ev, _ = SL.corpus_features(synth, synth.config, heldout, nt, 0.8)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = SL.evaluate_synthesis(synth, feats_ev, heldout["art"], steps=10)
        rec["evaluate_ms"] = (time.perf_counter() - t0) * 1e3
        rec["evaluate"] = metrics
        rec["evaluate_launches"] = {fn.__name__: fn.launches for fn in counters}
        if rec["evaluate_launches"]["small_attention"] == 0 or not np.isfinite(
                metrics["loud_corr"]):
            raise AssertionError(f"phase 8 evaluate_synthesis: {rec['evaluate_launches']}, "
                                 f"{metrics}")
        log(f"phase 8 CFM {precision}: evaluate_synthesis on 8 held-out utterances (midpoint, "
            f"10 steps) {rec['evaluate_ms']:.1f} ms, small attention launched "
            f"{rec['evaluate_launches']['small_attention']} times; pitch_corr "
            f"{metrics['pitch_corr']:.3f}, loud_corr {metrics['loud_corr']:.3f} (random "
            f"weights)  [{smi}]")
        runs[precision] = rec
        del state, synth, feats, batch, feats_ev
        torch.cuda.empty_cache()
    launches = {fn.__name__: sum(r["launches_over_run"][fn.__name__]
                                 + r["evaluate_launches"][fn.__name__] for r in runs.values())
                for fn in counters}
    return runs, launches


def full_vq_step(torch, smi):
    """One joint-VQ step (and a warm-up) at full width with the quantizer
    shape of ``sylber_resynthesis_tokens_mini.yaml`` on 768-d features."""
    import yaml

    from sylber_tpu_torch.flow.quantizer import quantizer_forward, vq_ema_update
    from sylber_tpu_torch.synthesis import make_synthesis_optimizer
    from sylber_tpu_torch.train import synthesis_loop as SL
    from sylber_tpu_torch.train import vq_synthesis as VQ

    cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    tok = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis_tokens_mini.yaml").read_text())
    _, sc, synth, nt, mt = _quiet_setup(SL, cfg, "cuda")
    qcfg = VQ.quantizer_config_from_dict(tok["model"]["quantizer_configs"],
                                         input_dim=sc.hubert.hidden_size)
    B = cfg["train"]["batch_size"]
    corpus = SL.build_synthesis_corpus(B, 5.0, seed=5)
    feats, _ = SL.corpus_features(synth, sc, corpus, nt, mt)
    batch = {"features": feats, "art": torch.from_numpy(corpus["art"]).cuda()}
    opt = make_synthesis_optimizer(lr=1e-4, warmup_steps=10, total_steps=1000)
    state = VQ.init_vq_synthesis_train_state(synth, qcfg, opt, seed=7)
    step = VQ.make_vq_synthesis_train_step(synth, qcfg, opt, commit_weight=1.0,
                                           pitch_weight=1.0)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(state, batch, 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # the codebooks' EMA update alone, on this step's pre-VQ outputs
    with torch.no_grad():
        out = quantizer_forward(state.quantizer, qcfg, feats)
    nb = (feats ** 2).sum(-1) > 0
    P, n_art = qcfg.pitch_emb_dim, qcfg.art_vq.groups * qcfg.art_vq.num_quantizers
    gen = torch.Generator(device="cuda").manual_seed(0)
    ema_ms = time_ms(torch, lambda: (
        vq_ema_update(state.quantizer.art_vq, qcfg.art_vq, out["non_quantized"][..., :-P],
                      out["indices"][..., :n_art], gen, mask=nb),
        vq_ema_update(state.quantizer.pitch_vq, qcfg.pitch_vq, out["non_quantized"][..., -P:],
                      out["indices"][..., n_art:], gen, mask=nb)), reps=5)
    vals = {k: float(v) for k, v in m.items()}
    ok = all(np.isfinite(v) for v in vals.values())
    rec = dict(batch=B, frames=int(feats.shape[1]), step_ms=ms, ema_update_ms=ema_ms,
               metrics=vals, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               ok=bool(ok))
    log(f"phase 8 joint VQ: B{B} x {rec['frames']} frames, quantizer 768 -> [128, 128] -> 32 "
        f"(art 24 x 256 codes, pitch 8 x 64): step {ms:.1f} ms (after one warm-up), of it the "
        f"EMA update of both codebooks {ema_ms:.2f} ms (CUDA events), "
        f"max_memory_allocated {rec['max_memory_allocated_gb']:.2f} GB, "
        + ", ".join(f"{k} {v:.4g}" for k, v in vals.items()) + f" ok={ok}  [{smi}]")
    del state, synth, feats, batch
    torch.cuda.empty_cache()
    return rec


def full_vocoder_step(torch, smi):
    """``make_vocoder_train_step`` at ``SparcDecoderConfig()`` width (512
    initial channels, x320, the harmonic source off as in that config),
    B16 x 32 frames: step p50 of 5 after 2 warm-up, peak memory."""
    from sylber_tpu_torch.vocoder import SparcDecoderConfig, VocoderTrainConfig
    from sylber_tpu_torch.vocoder import make_vocoder_train_step

    gcfg = SparcDecoderConfig().generator
    init_fn, step_fn = make_vocoder_train_step(VocoderTrainConfig(model=gcfg))
    state = init_fn("cuda", seed=0)
    rng = np.random.RandomState(8)
    B, T = 16, 32
    feats = rng.randn(B, T, 14).astype(np.float32) * 0.5
    feats[..., 12] = np.log(rng.uniform(90, 250, (B, T)) / 100.0)
    wav = np.stack([speechlike(rng, T * 320) * 0.3 for _ in range(B)])
    args = [torch.from_numpy(a).cuda() for a in (feats, wav, rng.randn(B, 64).astype(np.float32))]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    vals = {k: float(v) for k, v in m.items()}
    p50 = float(np.median(times[2:]))
    rec = dict(batch=B, frames=T, step_ms=times[2:], step_ms_p50=p50, metrics=vals,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               ok=bool(all(np.isfinite(v) for v in vals.values())))
    log(f"phase 8 vocoder: B{B} x {T} frames ({T * 320} samples), generator 512 -> x320 + "
        f"MPD + MSD: step p50 {p50:.1f} ms (5 after 2 warm-up), max_memory_allocated "
        f"{rec['max_memory_allocated_gb']:.2f} GB, "
        + ", ".join(f"{k} {v:.4g}" for k, v in vals.items()) + f" ok={rec['ok']}  [{smi}]")
    del state, args
    torch.cuda.empty_cache()
    return rec


def _mini_batch(torch, B=4, seconds=1.2, seed=0):
    """Averaged/blanked 144-d features of random segments and the corpus's
    art (the CPU tests' batch)."""
    from sylber_tpu_torch.train.synthesis_loop import build_synthesis_corpus

    rng = np.random.RandomState(seed)
    art = build_synthesis_corpus(B, seconds, seed=seed)["art"]
    L = art.shape[1]
    feats = np.zeros((B, L, 144), np.float32)
    for b in range(B):
        t = 2
        while t < L - 3:
            n = rng.randint(3, 12)
            if rng.rand() > 0.15:
                feats[b, t:t + n] = rng.randn(144) * 0.4
            t += n
    return {"features": feats, "art": art.astype(np.float32)}


def _on(torch, d, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}


def _named(mods):
    """``{"<name>/<leaf>": tensor}`` over modules and encoder layers."""
    out = {}
    for n, m in mods:
        items = m.named_parameters() if hasattr(m, "named_parameters") else m.items()
        out.update({f"{n}/{k}": t for k, t in items})
    return out


def grads_of(mods):
    return {k: t.grad.detach().cpu() for k, t in _named(mods).items()}


def params_of(mods):
    return {k: t.detach().cpu() for k, t in _named(mods).items()}


def mini_training_agreement(torch, smi):
    """One CFM step (``mini_synth.npz``) and one joint-VQ step
    (``mini_vq_synth.npz`` + ``mini_vq_tokenizer.npz``) on the card and on
    the CPU with the same draws, fp32 at "highest", dropout 0: losses,
    gradients (the leaf with the largest difference named) and updated
    parameters; then ``vocoder_agreement``."""
    import dataclasses

    from sylber_tpu_torch.flow.cfm import cfm_draws
    from sylber_tpu_torch.flow.quantizer import vq_reseed_draw
    from sylber_tpu_torch.io.checkpoint import load_params_npz
    from sylber_tpu_torch.synthesis import (SegmentSynthesis, init_synthesis_train_state,
                                            make_synthesis_optimizer, make_synthesis_train_step,
                                            synthesis_config_from_dict)
    from sylber_tpu_torch.train import vq_synthesis as VQ
    from sylber_tpu_torch.vq_tokenizer import TrainedVQTokenizer

    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    host = _mini_batch(torch)
    g = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    draws = cfm_draws(host["art"].shape, *g, device="cpu")
    opt_kw = dict(lr=4e-4, warmup_steps=0, total_steps=100, min_factor=0.05)
    checks = []

    def synth_on(name, dev):
        mc = json.loads((FIXTURES / f"{name}.json").read_text())["config"]["model"]
        sc = synthesis_config_from_dict(mc)
        sc = dataclasses.replace(sc, input_dropout=0.0, regressor=dataclasses.replace(
            sc.regressor, precision="highest"))
        return SegmentSynthesis(config=sc, params={"hubert": enc, **load_params_npz(
            str(FIXTURES / f"{name}.npz"))}, device=dev), mc

    # the CFM step
    out = {}
    for dev in ("cuda", "cpu"):
        synth, _ = synth_on("mini_synth", dev)
        opt = make_synthesis_optimizer(**opt_kw)
        state = init_synthesis_train_state(synth, opt)
        d = type(draws)(*(t.to(dev) if torch.is_tensor(t) else t for t in draws))
        m = make_synthesis_train_step(synth, opt)(state, _on(torch, host, dev), 0, draws=d)
        mods = (("input_mlp", synth.input_mlp), ("regressor", synth.regressor))
        out[dev] = dict(loss=float(m["cfm_loss"]), grads=grads_of(mods), params=params_of(mods))
    checks.append(_agreement("CFM step, mini_synth.npz (B4 x 60 frames)", out, SYNTH_GRAD_RTOL))

    # the joint-VQ step
    mc = json.loads((FIXTURES / "mini_vq_synth.json").read_text())["config"]
    out = {}
    nb = torch.from_numpy((host["features"] ** 2).sum(-1).reshape(-1) > 0).float()
    qcfg = VQ.quantizer_config_from_dict(mc["model"]["quantizer_configs"], input_dim=144)
    sample_idx = tuple(vq_reseed_draw(torch.Generator().manual_seed(5 + i), nb,
                                      (1, 1, c.codebook_size))
                       for i, c in enumerate((qcfg.art_vq, qcfg.pitch_vq)))
    for dev in ("cuda", "cpu"):
        synth, _ = synth_on("mini_vq_synth", dev)
        tok = TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg,
                                          device=dev)
        opt = make_synthesis_optimizer(**opt_kw)
        state = VQ.init_vq_synthesis_train_state(synth, qcfg, opt, quantizer=tok.state)
        with torch.no_grad():
            state.pitch_head["kernel"].fill_(0.1)
        d = type(draws)(*(t.to(dev) if torch.is_tensor(t) else t for t in draws))
        m = VQ.make_vq_synthesis_train_step(synth, qcfg, opt, pitch_weight=1.0)(
            state, _on(torch, host, dev), 0, draws=d,
            sample_idx=tuple(s.to(dev) for s in sample_idx))
        mods = [("input_mlp", synth.input_mlp), ("regressor", synth.regressor)] + [
            (f"qenc_{i}", layer) for i, layer in enumerate(state.quantizer.encoder)]
        p = params_of(mods)
        p.update({f"vq/{n}/{i}": t.cpu() for n, vq in (("art", state.quantizer.art_vq),
                                                        ("pitch", state.quantizer.pitch_vq))
                  for i, t in enumerate(vq)})
        out[dev] = dict(loss=float(m["loss"]), grads=grads_of(mods), params=p)
    checks.append(_agreement("joint-VQ step, mini_vq_synth.npz", out, SYNTH_GRAD_RTOL))

    checks += vocoder_agreement(torch)
    for c in checks:
        params = ("not compared" if c["params_total"] is None else
                  f"{c['params_off']} of {c['params_total']} (largest "
                  f"{c['param_max_abs_err']:.3g}; {c['params_flipped']} more at gradients within "
                  f"the largest difference of 0)")
        log(f"phase 8 card vs CPU, {c['what']}: loss rel {c['loss_rel']:.3g} (tol "
            f"{SYNTH_LOSS_RTOL}), gradients {c['grad']['rel']:.3g} of the largest (tol "
            f"{c['grad_tol'] or 'none: reported'}), L2 {c['grad']['l2_rel']:.3g} of the norm, "
            f"set by {c['grad']['leaf']} ({c['grad']['leaf_own_rel']:.3g} of its own largest; "
            f"next " + ", ".join(f"{k} {e:.3g}" for k, e in c["grad"]["top"][1:3])
            + f"); parameters off by more than {SYNTH_PARAM_ATOL}: {params} ok={c['ok']}  [{smi}]")
    return checks


def vocoder_agreement(torch, dev="cuda"):
    """One ``make_vocoder_train_step`` step (``mini_vocoder.npz``, seeded
    discriminators, B2 x 8 frames at 250 Hz, where the source's phase sum
    is exact) on ``dev`` and on the CPU at "highest": in float64 the whole
    step (both losses, every gradient, every updated parameter); in float32
    the losses, the discriminators' gradients and parameters from the same
    start, and the generator's gradient against the same (the CPU's
    updated) discriminators, reported beside the float64 one."""
    from sylber_tpu_torch.io.checkpoint import generator_state_dict_from_jax, load_params_npz
    from sylber_tpu_torch.models.hubert import matmul_precision
    from sylber_tpu_torch.vocoder import HiFiGANConfig, VocoderTrainConfig
    from sylber_tpu_torch.vocoder import make_vocoder_train_step
    from sylber_tpu_torch.vocoder.hifigan import generator_step_loss

    meta = json.loads((FIXTURES / "mini_vocoder.json").read_text())
    vcfg = VocoderTrainConfig(model=HiFiGANConfig(**meta["generator"]))
    gen = generator_state_dict_from_jax(load_params_npz(str(FIXTURES / "mini_vocoder.npz")))
    rng = np.random.RandomState(0)
    B, T = 2, 8
    feats = rng.randn(B, T, 14).astype(np.float32) * 0.5
    feats[..., 12] = np.float32(np.log(2.5))
    vhost = {"f": feats, "w": np.stack([speechlike(rng, T * 320) * 0.3 for _ in range(B)]),
             "c": rng.randn(B, 64).astype(np.float32),
             "n": rng.randn(B, T * 320).astype(np.float32)}
    checks = []

    def step(d, dtype):
        init_fn, step_fn = make_vocoder_train_step(vcfg, precision="highest")
        state = init_fn(d, seed=3, generator_state=gen)
        for m in (state.generator, state.mpd, state.msd):
            m.to(dtype)
        v = {k: t.to(dtype) for k, t in _on(torch, vhost, d).items()}
        return state, v, step_fn(state, v["f"], v["w"], v["c"], noise=v["n"])

    out = {}
    for key, d in (("cpu", "cpu"), ("cuda", dev)):
        state, _, m = step(d, torch.float64)
        mods = (("gen", state.generator), ("mpd", state.mpd), ("msd", state.msd))
        out[key] = dict(loss=[float(m["d_loss"]), float(m["g_loss"])], grads=grads_of(mods),
                      params=params_of(mods))
    checks.append(_agreement("vocoder step in float64, mini_vocoder.npz (B2 x 8 frames): "
                             "both losses, all three networks", out, SYNTH_GRAD_RTOL))
    out, states = {}, {}
    for key, d in (("cpu", "cpu"), ("cuda", dev)):
        state, v, m = step(d, torch.float32)
        states[key] = state
        discs = (("mpd", state.mpd), ("msd", state.msd))
        out[key] = dict(loss=float(m["d_loss"]), grads=grads_of(discs), params=params_of(discs))
    checks.append(_agreement("vocoder step in float32: the discriminators", out,
                             SYNTH_GRAD_RTOL, adam_flips=True))
    out = {}
    for key, d in (("cpu", "cpu"), ("cuda", dev)):
        init_fn, _ = make_vocoder_train_step(vcfg, precision="highest")
        fresh = init_fn(d, seed=3, generator_state=gen)
        fresh.mpd.load_state_dict(states["cpu"].mpd.state_dict())
        fresh.msd.load_state_dict(states["cpu"].msd.state_dict())
        v = _on(torch, vhost, d)
        with matmul_precision("highest"):
            loss, _ = generator_step_loss(vcfg, fresh.generator, fresh.mpd, fresh.msd, v["f"],
                                          v["w"], v["c"], v["n"])
            loss.backward()
        out[key] = dict(loss=float(loss.detach()), grads=grads_of((("gen", fresh.generator),)),
                        params=None)
    checks.append(_agreement("vocoder step in float32: the generator against the same "
                             "discriminators (its gradient reported, held in float64)", out))
    return checks


def _agreement(what, out, grad_tol=None, adam_flips=False):
    """Card against CPU: the loss or losses, the gradients (largest element
    against ``grad_tol`` of the largest, or reported only where it is
    None), the updated parameters where given (with ``adam_flips``, an
    element off by more than SYNTH_PARAM_ATOL is let pass only where its
    CPU gradient lies within the gradients' largest difference of 0)."""
    g, c = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(np.atleast_1d(g["loss"]),
                                                       np.atleast_1d(c["loss"])))
    gap = gradient_gap(g["grads"], c["grads"])
    off = flipped = total = worst = None
    if c["params"] is not None:
        off = flipped = total = 0
        for k, v in c["params"].items():
            far = (g["params"][k] - v).abs() > SYNTH_PARAM_ATOL
            if adam_flips:
                near_zero = c["grads"][k].abs() <= gap["leaf_abs"]
                flipped += int((far & near_zero).sum())
                far = far & ~near_zero
            off += int(far.sum())
            total += v.numel()
        worst = max(float((g["params"][k] - v).abs().max()) for k, v in c["params"].items())
    ok = (loss_rel <= SYNTH_LOSS_RTOL and not off
          and (grad_tol is None or gap["rel"] <= grad_tol))
    return dict(what=what, loss_cuda=g["loss"], loss_cpu=c["loss"], loss_rel=loss_rel,
                grad=gap, grad_tol=grad_tol, params_off=off, params_flipped=flipped,
                params_total=total, param_max_abs_err=worst, ok=bool(ok))


def synthesis_training_phase(torch, ops, counters, smi):
    """Phase 8: the resynthesis trainers on the card. Any failed check raises."""
    from sylber_tpu_torch.flow import kmeans as km
    from sylber_tpu_torch.models.hubert import matmul_precision

    with matmul_precision("highest"):
        seeding = kmeanspp_records(torch, km, smi)
    bad = [r for r in seeding if not r["ok"]]
    if bad:
        raise AssertionError(f"kmeanspp disagrees with its plain version: {bad}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_synth_") as tmp:
        fit = fit_kmeans_run(torch, km, smi)
        if not fit["ok"]:
            raise AssertionError(f"phase 8 fit_kmeans: {fit}")
        runs, launches = full_cfm_runs(torch, counters, smi, tmp)
    vq = full_vq_step(torch, smi)
    voc = full_vocoder_step(torch, smi)
    mini = mini_training_agreement(torch, smi)
    bad = [c["what"] for c in mini if not c["ok"]] + [n for n, r in (("vq", vq), ("vocoder", voc))
                                                       if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 8 failed: {bad}")
    return dict(kmeanspp=seeding, fit_kmeans=fit, cfm=runs, launches=launches, vq=vq,
                vocoder=voc, mini=mini, kmeanspp_launches=fit["kmeanspp_launches"])


def reproduce_synthesis(torch, smi):
    """``configs/sylber_resynthesis_mini.yaml`` trained on the card by the
    port (6,000 steps, the trained ``mini_ckpt.npz`` encoder), evaluated with
    50 ODE steps: the recorded eval is ``mini_synth.json``'s; the JAX
    package's gates are pitch_corr > 0.5 and loud_corr > 0.6."""
    import yaml

    from sylber_tpu_torch.train.synthesis_loop import train_synthesis

    cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis_mini.yaml").read_text())
    cfg["speech_model_ckpt"] = str(FIXTURES / "mini_ckpt.npz")
    recorded = json.loads((FIXTURES / "mini_synth.json").read_text())["eval"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reproduce_") as tmp:
        t0 = time.perf_counter()
        _, ev = train_synthesis(cfg, out_dir=tmp, log_every=500, eval_steps=50, device="cuda")
        wall = time.perf_counter() - t0
    ok = ev["pitch_corr"] > 0.5 and ev["loud_corr"] > 0.6
    log(f"reproduce: sylber_resynthesis_mini.yaml, {cfg['train']['max_steps']} steps on the "
        f"card in {wall:.1f} s: pitch_corr {ev['pitch_corr']:.4f} (recorded "
        f"{recorded['pitch_corr']:.4f}), loud_corr {ev['loud_corr']:.4f} (recorded "
        f"{recorded['loud_corr']:.4f}), art_l1_voiced {ev['art_l1_voiced']:.4f} (recorded "
        f"{recorded['art_l1_voiced']:.4f}); gates > 0.5 / > 0.6 ok={ok}  [{smi}]")
    log(json.dumps(dict(reproduce=ev, recorded=recorded, wall_s=wall)))
    if not ok:
        raise AssertionError(f"the reproduced mini eval misses the gates: {ev}")
    return ev


# ---------------------------------------------------------------- phase 9

# the encoder's four int8 products (M, K, N) at the 5 s and the 12-20 s
# buckets' rows (32 x 249 and 32 x 999 frames): the fused q/k/v projection,
# the out projection, and the feed-forward pair
INT8_GEMM_SHAPES = [(M, K, N) for M in (7968, 31968)
                    for K, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768))]
# awkward shapes, correctness only: the mini widths (K 144, 576), the tests'
# K 48, K 20 (not a multiple of 16: the padded row), one row, N off the
# 8-wide tile, and a strided output (the last)
INT8_EDGE_SHAPES = [(1000, 144, 432), (1000, 576, 144), (333, 48, 100), (300, 20, 70),
                    (1, 768, 2304), (517, 144, 13), (700, 768, 300)]
# the GateLoop recurrence at the regressor's shapes: 8 x 5 s and 1 x 20 s,
# 16 register tokens included, width 512
GATELOOP_SHAPES = [(8, 265, 512), (1, 1015, 512)]
# the GateLoop lengths at the chunks' edges (chunks of 16 steps, 16 warps a
# block, segments of 16 chunks): below, at and just past one chunk, more
# chunks than a block has warps, five segments; widths off the 32 lanes
GATELOOP_EDGE_SHAPES = [(2, 5, 40), (2, 16, 40), (2, 17, 40), (3, 300, 100), (1, 1100, 72)]
# least cycles of one GateLoop step's dependent chain: a multiply and an add
# (4 each, assumed instruction latencies)
GATELOOP_CHAIN_CYCLES = 8
GATELOOP_SEGMENT_CHUNKS = 16  # SEG of csrc/gateloop.cu: the chunks a block holds at once


def gateloop_chain_steps(L: int, chunk: int) -> int:
    """The multiply-add pairs on the chunked GateLoop kernel's chain: each
    segment walks a chunk twice (phases 1 and 3) and combines its chunks'
    carries in order (phase 2)."""
    n = -(-L // chunk)
    return 2 * chunk * -(-n // GATELOOP_SEGMENT_CHUNKS) + n


def bf16_values(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (nearest even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def half_integer_rows(rng, R: int, K: int, dtype: str) -> np.ndarray:
    """(R, K) float32 rows whose quotients x / scale lie at or next to
    half-integers, where the reciprocal's product and the IEEE quotient can
    round to different integers: column 0 holds the row's max |x| (every
    fourth row 127 * 2^e, so its quotients are exact and ties occur), the
    others the values whose quotients lie nearest to k + 1/2 (float32:
    fl((k + 1/2) scale) and two ulps either side, repeated where K asks for
    more; ``dtype`` "bfloat16": every bf16 value up to the max), with random
    signs."""
    f32 = np.float32
    finite_bf16 = (np.arange(0x7F80, dtype=np.uint32) << 16).view(f32)
    rows = np.empty((R, K), f32)
    for r in range(R):
        amax = f32(127 * 2.0 ** rng.randint(-6, 3)) if r % 4 == 0 else f32(rng.uniform(0.05, 40))
        scale = amax / f32(127)
        if dtype == "bfloat16":
            amax = bf16_values(amax)[()]
            scale = amax / f32(127)
            pos = finite_bf16[finite_bf16 <= amax]
        else:
            near = [(np.arange(127, dtype=f32) + f32(0.5)) * scale]
            for way in (f32(np.inf), f32(-np.inf)):
                near += [np.nextafter(near[0], way)]
                near += [np.nextafter(near[-1], way)]
            pos = np.unique(np.concatenate(near))
            pos = pos[pos <= amax]
        quot = pos / scale
        gap = np.abs(np.abs(quot - np.floor(quot)) - f32(0.5))
        pick = np.resize(pos[np.argsort(gap, kind="stable")[:K - 1]], K - 1)  # repeated if few
        rows[r, 0] = amax if r % 2 else -amax
        rows[r, 1:] = rng.permutation(pick * np.where(rng.rand(K - 1) < 0.5, f32(-1), f32(1)))
    return rows


def reciprocal_disagreements(x: np.ndarray) -> int:
    """The values of float32 rows ``x`` whose rint(x * (1 / scale)) differs
    from rint(x / scale): those the quantizer must take the IEEE quotient
    for (the crafted rows' teeth)."""
    scale = np.maximum(np.abs(x).max(1, keepdims=True), np.float32(1e-8)) / np.float32(127)
    return int((np.rint(x * (np.float32(1) / scale)) != np.rint(x / scale)).sum())


def int8_records(torch, i8):
    """Both int8 kernels against their plain versions (bit for bit) at the
    encoder's products, fp32 and bf16 activations and output, timed (CUDA
    graphs of 20 launches) beside the plain versions, the bounds and the
    yardsticks: ``torch._int_mm`` with the same rescale in torch ops
    (``library_ms``), ``_int_mm`` alone, and the bf16 ``F.linear`` of the
    shape (what the bf16 fast mode pays for the product)."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    quant, gemm = [], []
    for M, K, N in INT8_GEMM_SHAPES:
        w = torch.randn(N, K, device=dev, generator=gen) * 0.02
        b = torch.randn(N, device=dev, generator=gen) * 0.1
        wq, sw = i8.quantize_rows(w)
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            x = torch.randn(M, K, device=dev, generator=gen).to(tdt)
            xq, sx = i8.quantize_rows(x)
            bad, qerr = 0, 0.0
            for src, q, sc in ((x, xq, sx), (w, wq, sw)):
                pq, ps = i8.quantize_symmetric_plain(src)
                bad += int((q != pq).sum()) + int(
                    (sc.view(torch.int32) != ps[:, 0].contiguous().view(torch.int32)).sum())
                qerr = max(qerr, (q.float() - pq.float()).abs().max().item(),
                           (sc - ps[:, 0]).abs().max().item())
            out = i8.int8_gemm(xq, sx, wq, sw, b, tdt)
            want = i8.int8_gemm_plain(xq, sx, wq, sw, b, tdt)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            gbad = int((out.float() != want.float()).sum())
            seen = [r for r in quant if r["shape"] == [M, K] and r["dtype"] == dt]
            if not seen:
                # x read once, a byte a value and a scale a row written
                qb_ms, qb_by = bound_ms(M * K * (x.element_size() + 1) + 4 * M, 3.0 * M * K,
                                        "float32")
                quant.append(dict(shape=[M, K], dtype=dt, mismatches=bad, ok=bad == 0,
                                  max_abs_err=qerr,
                                  ms=graph_time_ms(torch, lambda: i8.quantize_rows(x), 20),
                                  eager_ms=time_ms(torch, lambda: i8.quantize_rows(x), 20),
                                  plain_ms=graph_time_ms(
                                      torch, lambda: i8.quantize_symmetric_plain(x), 5),
                                  library_ms=None, bound_ms=qb_ms, bound_by=qb_by))
            else:  # the shape is timed already; its check still counts
                seen[0]["mismatches"] += bad
                seen[0]["max_abs_err"] = max(seen[0]["max_abs_err"], qerr)
                seen[0]["ok"] = seen[0]["mismatches"] == 0
            nbytes = M * K + N * K + M * N * out.element_size() + 4 * (M + N)
            gb_ms, gb_by = bound_ms(nbytes, 2.0 * M * N * K, "int8")
            run = lambda: i8.int8_gemm(xq, sx, wq, sw, b, tdt)  # noqa: E731
            rec = dict(shape=[M, K, N], dtype=dt, max_abs_err=err, mismatches=gbad, tol=0.0,
                       ok=gbad == 0 and bool(torch.isfinite(out).all()),
                       ms=graph_time_ms(torch, run, 20), eager_ms=time_ms(torch, run, 20),
                       plain_ms=graph_time_ms(
                           torch, lambda: i8.int8_gemm_plain(xq, sx, wq, sw, b, tdt), 3),
                       bound_ms=gb_ms, bound_by=gb_by,
                       library="torch._int_mm + the rescale in torch ops")
            a_mm, b_mm = xq.contiguous(), wq.contiguous()
            try:
                rec["int_mm_ms"] = graph_time_ms(torch, lambda: torch._int_mm(a_mm, b_mm.t()), 20)
                rec["library_ms"] = graph_time_ms(torch, lambda: (
                    torch._int_mm(a_mm, b_mm.t()).float() * sx[:, None] * sw[None, :] + b
                ).to(tdt), 20)
            except RuntimeError as e:  # a yardstick only: recorded, not a failure
                rec.update(int_mm_ms=None, library_ms=None, library_error=str(e)[:200])
            xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
            rec["bf16_linear_ms"] = graph_time_ms(torch, lambda: F.linear(xb, wb, bb), 20)
            rec["tops"] = 2.0 * M * N * K / (rec["ms"] * 1e-3) / 1e12  # int8 TOP/s reached
            gemm.append(rec)
        del x, xq, w, wq
    torch.cuda.empty_cache()
    return quant, gemm


def gemm_sass(kernels):
    """The matrix instructions in the int8 GEMM's functions of the built
    library, from ``cuobjdump -sass``: wgmma's integer form is IGMMA
    (``mma.sync``'s would be IMMA). ``ok`` when every instance has IGMMA."""
    import re
    import shutil

    tool = Path(kernels._build._nvcc()).parent / "cuobjdump"
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if exe is None:
        raise AssertionError("cuobjdump not found: the GEMM's instructions cannot be checked")
    sass = subprocess.run([exe, "-sass", str(kernels.build())], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = set()
        elif name is not None:
            funcs[name].update(re.findall(r"\b([A-Z]*GMMA|[A-Z]MMA)\b", line))
    gemm = {n: sorted(ops) for n, ops in funcs.items() if "int8_gemm_kernel" in n}
    return dict(functions=gemm, ok=bool(gemm) and all("IGMMA" in o for o in gemm.values()))


def int8_edges(torch, i8):
    """Both int8 kernels at ``INT8_EDGE_SHAPES``, fp32 and bf16, bit for bit
    against the plain versions; the last shape writes into columns 3 ..
    3 + N of a wider buffer, whose other columns must stay as they were."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    records = []
    for i, (M, K, N) in enumerate(INT8_EDGE_SHAPES):
        strided = i == len(INT8_EDGE_SHAPES) - 1
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            x = torch.randn(M, K, device=dev, generator=gen).to(tdt)
            w = torch.randn(N, K, device=dev, generator=gen) / K ** 0.5
            b = torch.randn(N, device=dev, generator=gen) * 0.1
            xq, sx = i8.quantize_rows(x)
            wq, sw = i8.quantize_rows(w)
            pq, ps = i8.quantize_symmetric_plain(x)
            qbad = int((xq != pq).sum()) + int((sx != ps[:, 0]).sum())
            wide = torch.full((M, N + 7), -7.0, device=dev, dtype=tdt)
            out = wide[:, 3:3 + N] if strided else None
            got = i8.int8_gemm(xq, sx, wq, sw, b, tdt, out=out)
            want = i8.int8_dense_plain(x, w, b, tdt)
            torch.cuda.synchronize()
            gbad = int((got.float() != want.float()).sum())
            kept = not strided or bool((wide[:, :3] == -7).all() and (wide[:, 3 + N:] == -7).all())
            records.append(dict(shape=[M, K, N], dtype=dt, strided=strided,
                                quantize_mismatches=qbad, gemm_mismatches=gbad,
                                neighbours_kept=kept,
                                max_abs_err=(got.float() - want.float()).abs().max().item(),
                                ok=qbad == 0 and gbad == 0 and kept))
    return records


# the crafted rows of int8_half_integers: (dtype, rows, K) at 16-byte loads
# held in registers, scalar loads, and a K past the register-held width
HALF_INTEGER_SHAPES = [("float32", 512, 768), ("float32", 64, 50), ("float32", 64, 3200),
                       ("bfloat16", 512, 768), ("bfloat16", 64, 44), ("bfloat16", 64, 6400)]


def int8_half_integers(torch, i8):
    """The quantizer bit for bit against its plain version (values and
    scales) on ``half_integer_rows`` (quotients at and next to k + 1/2) at
    ``HALF_INTEGER_SHAPES``; ``teeth``: the values there whose reciprocal
    product alone would round otherwise (must be some)."""
    dev = torch.device("cuda")
    records = []
    for dt, R, K in HALF_INTEGER_SHAPES:
        x = half_integer_rows(np.random.RandomState(R + K), R, K, dt)
        xt = torch.from_numpy(x).to(dev, getattr(torch, dt))
        q, sc = i8.quantize_rows(xt)
        pq, ps = i8.quantize_symmetric_plain(xt)
        bad = int((q != pq).sum()) + int(
            (sc.view(torch.int32) != ps[:, 0].contiguous().view(torch.int32)).sum())
        teeth = reciprocal_disagreements(x)
        records.append(dict(dtype=dt, shape=[R, K], mismatches=bad, teeth=teeth,
                            ok=bad == 0 and teeth > 0))
    return records


def gateloop_records(torch, gl):
    """The GateLoop kernel against its plain version (bit for bit) on thirds
    of one (B, L, 3D) product at the regressor's shapes, timed beside its
    byte bound and its chain bound (the chunked design's chain,
    ``gateloop_chain_steps``; beside it the sequential walk's, L pairs),
    then at ``GATELOOP_EDGE_SHAPES`` (checked, not timed)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    clock = sm_clock_hz()
    records = []
    for B, L, D in GATELOOP_EDGE_SHAPES:
        q, kv, g = torch.randn(B, L, 3 * D, device=dev, generator=gen).chunk(3, dim=-1)
        a = torch.sigmoid(g)
        got, want = gl.gate_loop_operator(q, kv, a), gl.gate_loop_operator_plain(q, kv, a)
        bad = int((got != want).sum())
        records.append(dict(shape=[B, L, D], edge=True, mismatches=bad,
                            max_abs_err=(got - want).abs().max().item(),
                            ok=bad == 0 and bool(torch.isfinite(got).all())))
    for B, L, D in GATELOOP_SHAPES:
        q, kv, g = torch.randn(B, L, 3 * D, device=dev, generator=gen).chunk(3, dim=-1)
        a = torch.sigmoid(g)
        run = lambda: gl.gate_loop_operator(q, kv, a)  # noqa: E731
        plain = lambda: gl.gate_loop_operator_plain(q, kv, a)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        b_ms, b_by = bound_ms(16.0 * B * L * D, 3.0 * B * L * D, "float32")
        records.append(dict(shape=[B, L, D], dtype="float32", mismatches=bad, tol=0.0,
                            max_abs_err=(got - want).abs().max().item(),
                            ok=bad == 0 and bool(torch.isfinite(got).all()),
                            ms=graph_time_ms(torch, run, 20), eager_ms=time_ms(torch, run, 20),
                            plain_ms=graph_time_ms(torch, plain, 2), library_ms=None,
                            bound_ms=b_ms, bound_by=b_by, chain_steps=gateloop_chain_steps(
                                L, gl.CHUNK),
                            chain_bound_ms=gateloop_chain_steps(L, gl.CHUNK)
                            * GATELOOP_CHAIN_CYCLES / clock * 1e3,
                            sequential_chain_bound_ms=L * GATELOOP_CHAIN_CYCLES / clock * 1e3))
    return records


def int8_quantize_launches(torch, Segmenter, HubertConfig, i8):
    """The quantizer's launches in one int8 + bf16 ``process()`` call of the
    full-width Segmenter on each of phase 3's batches: with the weights
    cached, 4 a layer and encoder forward (the activations of the q/k/v,
    out and feed-forward products); after a ``load_state_dict`` of the same
    weights, the next call quantizes the weights again, once (q, k, v, out
    and the feed-forward pair: 6 launches a layer), and the one after does
    not."""
    cfg = HubertConfig(int8_encoder=True, dtype="bfloat16", frontend_dtype="bfloat16",
                       precision="default")
    seg = Segmenter(hubert_config=cfg)
    forwards = [0]
    seg.model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    rng = np.random.RandomState(1)
    batches = {"small_32x5s": [speechlike(rng, 5 * 16000) for _ in range(32)],
               "flash_32x12-20s": [speechlike(rng, int(rng.uniform(12, 20) * 16000))
                                   for _ in range(32)]}
    layers = cfg.num_hidden_layers
    records = []
    for bname, wavs in batches.items():
        seg.process(wavs, in_second=False)  # warm: the weights quantized here at the latest
        counts = []
        for reload in (False, True, False):
            if reload:
                seg.model.load_state_dict({k: v.clone() for k, v in seg.model.state_dict().items()})
            torch.cuda.synchronize()
            i8.quantize_rows.launches, forwards[0] = 0, 0
            seg.process(wavs, in_second=False)
            torch.cuda.synchronize()
            counts.append((i8.quantize_rows.launches, forwards[0]))
        want = [4 * layers * counts[0][1], 6 * layers + 4 * layers * counts[1][1],
                4 * layers * counts[2][1]]
        got = [c[0] for c in counts]
        records.append(dict(batch=bname, launches_warm=got[0], launches_after_reload=got[1],
                            launches_after=got[2], forwards=[c[1] for c in counts],
                            want=want, ok=got == want and counts[0][1] > 0))
    del seg
    torch.cuda.empty_cache()
    return records


def int8_mini_agreement(torch, Segmenter, HubertConfig):
    """``mini_ckpt.npz`` in int8 + bf16 on the card against its fp32 exact
    program on the card (phase 4's 18 held-out utterances: boundary F1 at
    tolerance 0 must reach 0.995), and against the same int8 program on the
    CPU (the utterances whose segments differ are reported; F1 >= 0.995)."""
    from sylber_tpu_torch.utils.metrics import boundary_f1

    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    kw = dict(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), norm_threshold=meta["norm_threshold"],
              merge_threshold=meta["merge_threshold"])
    layers = meta["encoding_layer"]
    int8_cfg = HubertConfig(num_hidden_layers=layers, dtype="bfloat16",
                            frontend_dtype="bfloat16", precision="default", int8_encoder=True,
                            **hub)
    rng = np.random.RandomState(9999)
    held = [speechlike(rng, int(rng.uniform(3.0, 8.0) * 16000)) for _ in range(16)]
    held += [speechlike(rng, int(s * 16000)) for s in (11.0, 14.0)]
    outs = {}
    for name, cfg, dev in (("exact", HubertConfig(num_hidden_layers=layers, **hub), "cuda"),
                           ("int8", int8_cfg, "cuda"), ("int8_cpu", int8_cfg, "cpu")):
        seg = Segmenter(device=dev, hubert_config=cfg, **kw)
        outs[name] = seg.process(held, in_second=False, return_hidden=False)

    def f1(a, b):
        return float(np.mean([boundary_f1(x["segments"], y["segments"], tol_frames=0)
                              for x, y in zip(outs[a], outs[b])]))

    nseg = int(sum(len(o["segments"]) for o in outs["exact"]))
    differ = [i for i, (x, y) in enumerate(zip(outs["int8"], outs["int8_cpu"]))
              if x["segments"].tolist() != y["segments"].tolist()]
    rec = dict(utterances=len(held), segments=nseg, f1_int8_vs_exact=f1("int8", "exact"),
               f1_card_vs_cpu=f1("int8", "int8_cpu"), utterances_differing_card_vs_cpu=differ)
    rec["ok"] = rec["f1_int8_vs_exact"] >= 0.995 and rec["f1_card_vs_cpu"] >= 0.995 and nseg > 0
    log(f"phase 9 mini_ckpt int8 + bf16 vs fp32 exact on the card: boundary F1 (tol 0) "
        f"{rec['f1_int8_vs_exact']:.5f} over {len(held)} utterances, {nseg} segments; int8 card "
        f"vs CPU: F1 {rec['f1_card_vs_cpu']:.5f}, utterances whose segments differ {differ} "
        f"ok={rec['ok']}")
    return rec


def gateloop_resynthesis(torch, counters, smi):
    """``resynthesize`` + ``decode_audio`` at full width on seeded random
    weights (``configs/sylber_resynthesis.yaml`` at "default" precision,
    ``SparcDecoderConfig()``), 8 x 5 s, midpoint with 5 steps, cond_scale 1:
    the gateloop layers off and on, five timed calls each; the gateloop run
    counts every launch from 0 (the GateLoop kernel, conv0, small attention
    and both segmentation passes must launch)."""
    import dataclasses
    import warnings

    import yaml

    from sylber_tpu_torch.synthesis import SegmentSynthesis, SynthesisConfig
    from sylber_tpu_torch.vocoder import SparcDecoder

    yaml_cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    base = SynthesisConfig.from_yaml_dict(yaml_cfg)
    wavs = [speechlike(np.random.RandomState(7), 5 * 16000) for _ in range(8)]
    wav_np, spk = np.stack(wavs), np.zeros((8, 64), np.float32)
    dev = torch.device("cuda")
    vocoder = SparcDecoder(device=dev)
    runs, launches = {}, None
    for gated in (False, True):
        cfg = dataclasses.replace(base, regressor=dataclasses.replace(
            base.regressor, use_gateloop_layers=gated))
        synth = SegmentSynthesis(config=cfg, thresholder_configs=yaml_cfg["thresholder_configs"],
                                 device=dev)

        def call():
            art, segs = synth.resynthesize(input_values=wav_np, steps=5)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # random-init vocoder: noise, not speech
                return art, segs, synth.decode_audio(art, spk, vocoder=vocoder)

        call()  # warm-up
        torch.cuda.synchronize()
        if gated:
            for fn in counters:
                fn.launches = 0
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            art, segs, audio = call()
            walls.append(time.perf_counter() - t0)
        if gated:
            launches = {fn.__name__: fn.launches for fn in counters}
        check_resynthesis_outputs(art, segs, audio, wavs, cfg)
        rtfx = sorted(wav_np.size / 16000.0 / w for w in walls)
        prof = profile(torch, call)
        name = "gateloop" if gated else "no_gateloop"
        runs[name] = dict(rtfx=rtfx[2], rtfx_min=rtfx[0], rtfx_max=rtfx[-1], wall_s=walls,
                          profile=prof)
        log(f"phase 9 resynthesis 8 x 5 s, {name}: wav -> wav RTFx median of 5 {rtfx[2]:.1f} "
            f"(min {rtfx[0]:.1f}, max {rtfx[-1]:.1f}); profiled call: device busy "
            f"{prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms, {prof['launches']} launches; "
            f"the port's kernels: " + ", ".join(f"{k} {v:.2f} ms"
                                                for k, v in prof["port_kernels_ms"].items())
            + f"  [{smi}]")
        del synth
        torch.cuda.empty_cache()
    needed = ("gate_loop_operator", "conv0_gn_gelu", "small_attention", "segment_pass1",
              "segment_pass2")
    idle = [n for n in needed if launches[n] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the gateloop resynthesis path: {idle}")
    return runs, launches


def int8_phase(torch, ops, counters, smi):
    """Phase 9: the int8 serving path and the gateloop regressor on the
    card. Any failed check raises."""
    from sylber_tpu_torch import Segmenter, kernels
    from sylber_tpu_torch.models.hubert import HubertConfig, matmul_precision

    i8, gl = ops.int8, ops.gateloop
    sass = gemm_sass(kernels)
    log(f"phase 9: cuobjdump -sass, matrix instructions of the int8 GEMM's functions: "
        f"{sass['functions']} (IGMMA in each: {sass['ok']})")
    if not sass["ok"]:
        raise AssertionError(f"the int8 GEMM's SASS has no IGMMA (wgmma): {sass}")
    with matmul_precision("highest"):
        quant, gemm = int8_records(torch, i8)
        edges = int8_edges(torch, i8)
        crafted = int8_half_integers(torch, i8)
        gate_recs = gateloop_records(torch, gl)
    gates = [r for r in gate_recs if not r.get("edge")]
    gate_edges = [r for r in gate_recs if r.get("edge")]
    for name, recs in (("quantize_rows", quant), ("int8_gemm", gemm)):
        for r in recs:
            yard = "" if name == "quantize_rows" else (
                f"  {r['tops']:.1f} TOP/s  library_ms (_int_mm + rescale) {r['library_ms']}  "
                f"int_mm_ms {r['int_mm_ms']}  bf16_linear_ms {r['bf16_linear_ms']:.4f}")
            log(f"phase 9: {name} {r['dtype']} {r['shape']}: {r['mismatches']} mismatches "
                f"(tol 0) ok={r['ok']}  kernel_ms {r['ms']:.4f} (eager {r['eager_ms']:.4f})  "
                f"plain_ms {r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
                f"{yard}  [{smi}]")
    log(f"phase 9: int8 edge shapes {len(edges)} calls, "
        f"{sum(e['quantize_mismatches'] + e['gemm_mismatches'] for e in edges)} mismatches, "
        f"strided output kept its neighbours "
        f"{all(e['neighbours_kept'] for e in edges if e['strided'])}")
    for r in crafted:
        log(f"phase 9: quantize_rows {r['dtype']} {r['shape']} at half-integer quotients: "
            f"{r['mismatches']} mismatches (tol 0), {r['teeth']} values the reciprocal alone "
            f"rounds otherwise ok={r['ok']}")
    for r in gates:
        log(f"phase 9: gate_loop_operator {r['shape']}: {r['mismatches']} mismatches (tol 0) "
            f"ok={r['ok']}  kernel_ms {r['ms']:.4f} (eager {r['eager_ms']:.4f})  plain_ms "
            f"{r['plain_ms']:.3f}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), chain "
            f"{r['chain_bound_ms']:.4f} ({r['chain_steps']} pairs; the sequential walk's "
            f"{r['sequential_chain_bound_ms']:.4f})  [{smi}]")
    log(f"phase 9: gate_loop_operator at the chunks' edges {[r['shape'] for r in gate_edges]}: "
        f"{sum(r['mismatches'] for r in gate_edges)} mismatches (tol 0)")
    bad = [r for r in quant + gemm + edges + crafted + gate_recs if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 9 kernels disagree with their plain versions: {bad}")

    int8_counters = counters + [i8.quantize_rows, i8.int8_gemm]
    fast = dict(dtype="bfloat16", frontend_dtype="bfloat16", precision="default")
    modes = {"fp32_highest": HubertConfig(), "bf16_default": HubertConfig(**fast),
             "int8_bf16": HubertConfig(int8_encoder=True, **fast)}
    import sylber_tpu_torch.api as api

    segment_batch = api.segment_batch
    api.segment_batch = forbid_host_syncs(torch, segment_batch)
    try:
        runs, launches, hidden = main_path(torch, Segmenter, HubertConfig, int8_counters,
                                           modes=modes, label="phase 9")
    finally:
        api.segment_batch = segment_batch
    cosines = {}
    for bname in ("small_32x5s", "flash_32x12-20s"):
        a = np.concatenate(hidden[("int8_bf16", bname)]).astype(np.float64)
        b = np.concatenate(hidden[("fp32_highest", bname)]).astype(np.float64)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)
        fb = np.concatenate(hidden[("bf16_default", bname)]).astype(np.float64)
        cos_bf16 = (fb * b).sum(-1) / (np.linalg.norm(fb, axis=-1) * np.linalg.norm(b, axis=-1)
                                       + 1e-30)
        cosines[bname] = dict(int8_min=float(cos.min()), int8_mean=float(cos.mean()),
                              bf16_min=float(cos_bf16.min()), bf16_mean=float(cos_bf16.mean()))
        log(f"phase 9 per-frame cosine of the hidden states against fp32, {bname}: int8 min "
            f"{cos.min():.5f} mean {cos.mean():.6f}; bf16 min {cos_bf16.min():.5f} mean "
            f"{cos_bf16.mean():.6f}")
    del hidden
    log(f"phase 9: launches over the three modes' runs: {launches}  [{smi}]")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the int8 path: {idle}")
    cached = int8_quantize_launches(torch, Segmenter, HubertConfig, i8)
    for r in cached:
        log(f"phase 9: quantize_rows launches a process() call, int8 + bf16, {r['batch']}: "
            f"{r['launches_warm']} warm, {r['launches_after_reload']} after a load_state_dict, "
            f"{r['launches_after']} the call after (encoder forwards {r['forwards']}; want "
            f"{r['want']}) ok={r['ok']}")
    if not all(r["ok"] for r in cached):
        raise AssertionError(f"phase 9: the int8 weights' cache: {cached}")
    mini = int8_mini_agreement(torch, Segmenter, HubertConfig)
    if not mini["ok"]:
        raise AssertionError(f"phase 9 mini_ckpt int8: {mini}")
    http = http_shim(None, "cuda", "--int8")
    resynthesis, gate_launches = gateloop_resynthesis(torch, counters + [gl.gate_loop_operator],
                                                      smi)
    log(f"phase 9: launches over the gateloop resynthesis runs: {gate_launches}  [{smi}]")
    return dict(quantize=quant, gemm=gemm, edges=edges, half_integers=crafted, gateloop=gates,
                gateloop_edges=gate_edges, sass=sass, runs=runs, cosines=cosines,
                launches=launches, quantize_launches=cached, mini=mini, http=http,
                resynthesis=resynthesis, gateloop_launches=gate_launches)


def int8_kernel_entries(p9):
    """The ``{"kernels": [...]}`` rows of phase 9's kernels: the headline
    shape is the 5 s bucket's fused q/k/v product (bf16, as the serving mode
    runs it), every shape beside it."""
    keys = ("shape", "dtype", "max_abs_err", "ms", "eager_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    rows = []
    for name, fn, recs, src, replaces in (
            ("int8_quantize", "quantize_rows", p9["quantize"], "int8_gemm.cu",
             "sylber_tpu/ops/int8.py:43"),
            ("int8_gemm", "int8_gemm", p9["gemm"], "int8_gemm.cu", "sylber_tpu/ops/int8.py:56")):
        head = next(r for r in recs if r["shape"][:2] == [7968, 768] and r["dtype"] == "bfloat16"
                    and (name == "int8_quantize" or r["shape"][2] == 2304))
        row = dict(name=name, route="cuda", source=f"sylber_tpu_torch/csrc/{src}",
                   replaces=replaces, launches=p9["launches"][fn],
                   **{k: head[k] for k in keys})
        row["shapes"] = [{k: r[k] for k in keys + ("int_mm_ms", "bf16_linear_ms", "tops")
                          if k in r} for r in recs]
        if name == "int8_gemm":
            row.update(tops=head["tops"], bf16_linear_ms=head["bf16_linear_ms"],
                       int_mm_ms=head["int_mm_ms"], sass=p9["sass"]["functions"])
        rows.append(row)
    head = p9["gateloop"][0]
    rows.append(dict(name="gate_loop", route="cuda", source="sylber_tpu_torch/csrc/gateloop.cu",
                     replaces="sylber_tpu/ops/gateloop.py:26",
                     launches=p9["gateloop_launches"]["gate_loop_operator"],
                     chain_bound_ms=head["chain_bound_ms"],
                     sequential_chain_bound_ms=head["sequential_chain_bound_ms"],
                     shapes=[{k: r[k] for k in keys + ("chain_bound_ms", "chain_steps",
                                                       "sequential_chain_bound_ms")}
                             for r in p9["gateloop"]],
                     **{k: head[k] for k in keys}))
    return rows


# ---------------------------------------------------------------- phase 10

CORPUS_UTTS = 64             # the phase's corpus: seeded speechlike utterances ...
CORPUS_SECONDS = (2.0, 20.0)  # ... of 2-20 s, as 16-bit WAV (and FLAC)
# a native segment may differ from the device's only where the oracle's
# smallest decision margin is at most this (tests/unit/test_native_segment.py)
NEAR_TIE_MARGIN = 1e-4
# mini_proof.evaluate on mini_ckpt.npz: boundary F1 against the truth within
# this of the CPU port's, and the fast mode's F1 against the exact mode's
EVAL_F1_TOL = 0.005
FAST_EXACT_F1_GATE = 0.995


def native_libraries():
    """Build both native libraries with g++ from the port's sources (a
    checkout holds none) and load them; the build time."""
    from sylber_tpu_torch.utils import native

    found = {n: native.library_path(n).exists() for n in ("segment", "flac")}
    t0 = time.perf_counter()
    paths = {n: native.build(n) for n in found}
    native.load_library()
    native.load_flac_library()
    return dict(build_s=time.perf_counter() - t0, found_built=found,
                libraries={n: str(p.relative_to(ROOT)) for n, p in paths.items()})


def decoder_times():
    """``speechlike.flac`` through the native decoder, the pure-Python one and
    libsndfile (where found): the samples must be equal; ms of host CPU per
    second of audio, each the mean of repeated decodes."""
    from sylber_tpu_torch.utils import flac, native, sndfile

    path = FIXTURES / "speechlike.flac"
    data = path.read_bytes()
    want = native.decode_flac_native(data)[0]
    audio_s = want.shape[1] / 16000.0
    decoders = {"native": (lambda: native.decode_flac_native(data)[0], 200),
                "python": (lambda: flac.decode_flac(data)[0], 5)}
    if sndfile.available():
        decoders["libsndfile"] = (lambda: sndfile.read(path, dtype="int16")[0].astype(np.int32),
                                  200)
    out = {}
    for name, (fn, reps) in decoders.items():
        equal = bool(np.array_equal(fn(), want))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = dict(equal=equal, ms_per_audio_s=(time.perf_counter() - t0) / reps * 1e3
                         / audio_s)
    return out


def write_corpus(d: Path, n: int, seconds, seed: int = 10):
    """``n`` seeded speechlike utterances as 16-bit WAV (``w*.wav``); where
    libsndfile is found, the same as FLAC through the port's writer
    (``f*.flac``) and ``speechlike.ogg``, else ``speechlike.flac``."""
    import shutil

    from scipy.io import wavfile

    from sylber_tpu_torch.utils import sndfile

    rng = np.random.RandomState(seed)
    pcms = []
    for i in range(n):
        w = speechlike(rng, int(rng.uniform(*seconds) * 16000))
        pcms.append(np.round(w / np.abs(w).max() * 30000).astype(np.int16))
        wavfile.write(d / f"w{i:02d}.wav", 16000, pcms[-1])
    if sndfile.available():
        for i, pcm in enumerate(pcms):
            sndfile.write(d / f"f{i:02d}.flac", pcm, 16000)
        shutil.copy(FIXTURES / "speechlike.ogg", d)
    else:
        shutil.copy(FIXTURES / "speechlike.flac", d)


class DecoderCounts:
    """Count the files each decoder reads inside the block (the runner's
    loading): libsndfile, the native FLAC decoder, the pure-Python one, and
    scipy's WAV reader."""

    def __enter__(self):
        from scipy.io import wavfile

        from sylber_tpu_torch.utils import flac, native, sndfile

        self.counts = dict(libsndfile=0, native_flac=0, python_flac=0, wav=0)
        self.saved = [(sndfile, "read", "libsndfile"), (native, "decode_flac_native",
                                                         "native_flac"),
                      (flac, "decode_flac", "python_flac"), (wavfile, "read", "wav")]
        for module, attr, key in self.saved:
            fn = getattr(module, attr)
            setattr(module, attr, self._counted(fn, key))
            setattr(self, f"_{key}", fn)
        return self.counts

    def _counted(self, fn, key):
        def counted(*a, **k):
            self.counts[key] += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for module, attr, key in self.saved:
            setattr(module, attr, getattr(self, f"_{key}"))
        return False


def run_corpus(torch, argv, counters=None):
    """``segment_corpus.main(argv)``, its stdout lines echoed; with
    ``counters``, the launches of each timed batch (from 0, by kernel)."""
    from sylber_tpu_torch import segment_corpus

    batches = []

    @contextlib.contextmanager
    def hook(bi):
        before = {fn.__name__: fn.launches for fn in counters}
        yield
        batches.append({fn.__name__: fn.launches - before[fn.__name__] for fn in counters})

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = segment_corpus.main(argv, batch_hook=hook if counters else None)
    for line in buf.getvalue().splitlines():
        log(f"  segment_corpus: {line}")
    out["batch_launches"] = batches
    return out


def frames_of(seconds: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(seconds) * 50.0).astype(np.int64)


def corpus_phase(torch, counters, smi, device="cuda", n_utts=CORPUS_UTTS,
                 seconds=CORPUS_SECONDS, widths_json=None):
    """Phase 10: the offline corpus path on the card, through its entry
    points (``segment_corpus``, ``precompute_segments``, ``mini_proof``).
    ``widths_json`` (a rehearsal on the CPU at a small width) replaces HuBERT
    base in the full-width runs. Any failed check raises."""
    from sylber_tpu_torch import Segmenter, mini_proof, precompute_segments, segment_corpus
    from sylber_tpu_torch.io.checkpoint import load_params_npz
    from sylber_tpu_torch.ops.segment_np import segment_oracle
    from sylber_tpu_torch.utils import native, sndfile

    on_card = device == "cuda"
    rep = dict(device=device, card=smi if on_card else None)
    rep["native"] = native_libraries()
    log(f"phase 10: native libraries {rep['native']['libraries']} built by g++ in "
        f"{rep['native']['build_s']:.2f} s (already built: {rep['native']['found_built']})")
    rep["decoders"] = decoder_times()
    log("phase 10: speechlike.flac (0.5 s) decoded on the card machine's host CPU, one core: "
        + ", ".join(f"{k} {v['ms_per_audio_s']:.3f} ms per audio second (samples equal "
                    f"{v['equal']})" for k, v in rep["decoders"].items()))
    if not all(v["equal"] for v in rep["decoders"].values()):
        raise AssertionError(f"phase 10: the FLAC decoders disagree: {rep['decoders']}")

    for fn in counters:
        fn.launches = 0
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        tmp = Path(tmp)
        corpus = tmp / "corpus"
        corpus.mkdir()
        write_corpus(corpus, n_utts, seconds)
        width = ["--model-config", widths_json] if widths_json else []
        dev = ["--device", device]

        # the runner at full width, bf16 fast mode, batch 32, launches counted a batch
        with DecoderCounts() as read_by:
            bf16 = run_corpus(torch, ["--audio-dir", str(corpus), "--out", str(tmp / "bf16.npz"),
                                      "--batch-size", "32", *width, *dev],
                              counters if on_card else None)
        rep["files_read_by"] = dict(read_by)
        names = sorted(bf16["results"])
        log(f"phase 10: {len(names)} files read by: {rep['files_read_by']} (libsndfile "
            f"{'found' if sndfile.available() else 'not found'})")
        rep["runner_bf16"] = dict(stats=bf16["stats"], load_s=bf16["load_seconds"],
                                  batch_walls=bf16["batch_walls"],
                                  batch_launches=bf16["batch_launches"])
        log(f"phase 10 segment_corpus bf16 full width: load {bf16['load_seconds']:.3f} s "
            f"outside the timed window; stats {json.dumps(bf16['stats'])}  [{smi}]")
        if on_card:
            log(f"phase 10: launches of each timed batch: {bf16['batch_launches']}")
            for b in bf16["batch_launches"]:
                missing = [k for k in ("conv0_gn_gelu", "segment_pass1", "segment_pass2")
                           if b[k] == 0]
                if missing or b["small_attention"] + b["flash_attention"] == 0:
                    raise AssertionError(f"phase 10: a timed batch launched {b}")

        # the same loaded arrays through Segmenter.process, in the runner's batches
        files, fnames = segment_corpus.find_audio(str(corpus))
        wavs = segment_corpus.load_corpus(files)
        widths = segment_corpus.model_widths(widths_json)
        seg = Segmenter(hubert_config=segment_corpus.segmenter_config(widths=widths),
                        length_bucket_s=4.0, device=device)
        direct, hidden = {}, {}
        for idx in segment_corpus.plan_batches(wavs, 32):
            for j, o in zip(idx, seg.process([wavs[j] for j in idx], in_second=False)):
                direct[fnames[j]], hidden[fnames[j]] = o["segments"], o["hidden_states"]
        del seg
        differ = [k for k in names if not np.array_equal(bf16["results"][k], direct[k] / 50.0)]
        log(f"phase 10: runner segments against Segmenter.process on the same arrays: "
            f"{len(names) - len(differ)} of {len(names)} equal")
        if differ:
            raise AssertionError(f"phase 10: the runner differs from process() on {differ[:5]}")

        again = run_corpus(torch, ["--audio-dir", str(corpus), "--out", str(tmp / "again.npz"),
                                   "--batch-size", "32", "--compare", str(tmp / "bf16.npz"),
                                   *width, *dev])
        fp32 = run_corpus(torch, ["--audio-dir", str(corpus), "--out", str(tmp / "fp32.npz"),
                                  "--batch-size", "32", "--dtype", "float32", "--precision",
                                  "highest", "--compare", str(tmp / "bf16.npz"), *width, *dev])
        rep["runner_bf16_again"] = dict(stats=again["stats"], compare=again["compare"])
        rep["runner_fp32"] = dict(stats=fp32["stats"], compare=fp32["compare"])
        log(f"phase 10 segment_corpus bf16 again, --compare its first output: "
            f"{again['compare']}; stats {json.dumps(again['stats'])}  [{smi}]")
        log(f"phase 10 segment_corpus fp32 highest, --compare the bf16 output (random weights, "
            f"no gate): {fp32['compare']}; stats {json.dumps(fp32['stats'])}  [{smi}]")
        if again["compare"]["boundary_f1_vs_compare"] != 1.0:
            raise AssertionError(f"phase 10: --compare against itself: {again['compare']}")

        # the trained fixture at its width, fp32 exact: the card against the CPU
        fixture = ["--audio-dir", str(corpus), "--ckpt", str(FIXTURES / "mini_ckpt.npz"),
                   "--model-config", str(FIXTURES / "mini_ckpt.json"),
                   "--norm-threshold", str(meta["norm_threshold"]),
                   "--merge-threshold", str(meta["merge_threshold"]),
                   "--dtype", "float32", "--precision", "highest"]
        fx = run_corpus(torch, [*fixture, "--out", str(tmp / "fx.npz"), *dev])
        t0 = time.perf_counter()
        fx_cpu = run_corpus(torch, [*fixture, "--out", str(tmp / "fx_cpu.npz"), "--device",
                                    "cpu", "--no-warmup"])
        cpu_s = time.perf_counter() - t0
        same = [k for k in names if fx["results"][k].tolist() == fx_cpu["results"][k].tolist()]
        rep["runner_fixture"] = dict(stats=fx["stats"], cpu_stats=fx_cpu["stats"],
                                     equal_to_cpu=len(same), files=len(names),
                                     segments=int(sum(len(v) for v in fx["results"].values())))
        log(f"phase 10 segment_corpus mini_ckpt.npz fp32 highest: {len(same)} of {len(names)} "
            f"files' segments equal to the CPU port's ({rep['runner_fixture']['segments']} "
            f"segments; the CPU run took {cpu_s:.1f} s); stats {json.dumps(fx['stats'])}  "
            f"[{smi}]")
        if len(same) != len(names):
            raise AssertionError("phase 10: the fixture runner's segments differ from the CPU's")

        # stage-1 segment files, in the runner's batches and buckets: on the device and --native
        order = [Path(fnames[j]).stem for idx in segment_corpus.plan_batches(wavs, 32)
                 for j in idx]
        (tmp / "tags.txt").write_text("\n".join(order) + "\n")
        pre = ["--manifest", str(tmp / "tags.txt"), "--wav-dir", str(corpus),
               "--batch-size", "32", "--dtype", "bfloat16", "--precision", "default",
               "--length-bucket-s", "4", *width, *dev]
        with contextlib.redirect_stdout(io.StringIO()):
            precompute_segments.main([*pre, "--out-dir", str(tmp / "dev")])
            t0 = time.perf_counter()
            precompute_segments.main([*pre, "--out-dir", str(tmp / "native"), "--native"])
            native_s = time.perf_counter() - t0
        stem = {Path(k).stem: k for k in names}
        dev_equal, ties, far = 0, [], []
        for tag in order:
            d_seg = np.load(tmp / "dev" / f"{tag}.npy")
            n_seg = np.load(tmp / "native" / f"{tag}.npy")
            dev_equal += d_seg.tolist() == frames_of(bf16["results"][stem[tag]]).tolist()
            if n_seg.tolist() != d_seg.tolist():
                _, margin = segment_oracle(hidden[stem[tag]], 2.6, 0.8, return_margin=True)
                (ties if margin <= NEAR_TIE_MARGIN else far).append((tag, margin))
        rep["precompute"] = dict(files=len(order), device_equal_runner=dev_equal,
                                 native_near_tie_differences=len(ties),
                                 native_far_differences=far, native_run_s=native_s)
        log(f"phase 10 precompute_segments: {dev_equal} of {len(order)} device .npy files equal "
            f"to the runner's frame segments; --native ({native_s:.1f} s) differs from the "
            f"device on {len(ties)} utterance(s) with a decision within {NEAR_TIE_MARGIN} of "
            f"its threshold, and on {len(far)} beyond it")
        if dev_equal != len(order) or far:
            raise AssertionError(f"phase 10 precompute_segments: {rep['precompute']}")

    # the held-out evaluation of mini_ckpt.npz: the card beside the CPU port and the record
    params = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    hub = mini_proof.hubert_config(meta["hubert"])
    ev = mini_proof.evaluate(params, hub, meta["norm_threshold"], device=device)
    ev_cpu = mini_proof.evaluate(params, hub, meta["norm_threshold"], device="cpu")
    rep["evaluate"] = dict(card=ev, cpu=ev_cpu, recorded=meta["eval"])
    for k in ev:
        log(f"phase 10 mini_proof.evaluate(mini_ckpt.npz) {k}: {device} {ev[k]:.6g}, CPU "
            f"{ev_cpu[k]:.6g}, recorded {meta['eval'][k]:.6g}")
    gap = abs(ev["boundary_f1_vs_truth_tol1"] - ev_cpu["boundary_f1_vs_truth_tol1"])
    if gap > EVAL_F1_TOL or ev["fast_vs_exact_boundary_f1_tol0"] < FAST_EXACT_F1_GATE:
        raise AssertionError(f"phase 10 evaluate: F1 gap {gap} (tol {EVAL_F1_TOL}), fast vs "
                             f"exact {ev['fast_vs_exact_boundary_f1_tol0']}")
    rep["launches"] = {fn.__name__: fn.launches for fn in counters}
    return rep


# ---------------------------------------------------------------- phase 11

MESH_STEPS, MESH_WARM = 13, 3  # phase 6's: 3 untimed steps, 10 timed
# FSDP at world size 1 against no process group, 13 bf16 steps: every
# parameter within this of the largest |parameter| (FSDP's flat reduce and
# its gathered copies may round the bf16 step's sums in another order)
MESH_FSDP_REL_TOL = 1e-5
# two ranks on one card against one process, fp32 "highest", dropout 0, 3
# steps of the recipe (lr 5e-5): losses rtol 1e-5, parameters within 1e-6
# (the steps move them by up to 1.5e-4; the rest is summation order)
GLOO_BATCH, GLOO_STEPS = 8, 3
GLOO_LOSS_RTOL, GLOO_PARAM_ATOL = 1e-5, 1e-6
MESH_F1_GATE = 0.995  # bf16 replicas of 16 rows against one model of 32 (cuBLAS may differ)


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms, no autotuning: two runs of one
    program give the same bits (the bit-equality of phase 11's runs)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def world1_run(torch, counters, label, recipe, out_dir, smi):
    """``train()`` for ``MESH_STEPS`` steps of ``recipe``: step p50 after
    ``MESH_WARM``, peak memory, the launches, and the whole parameters."""
    from sylber_tpu_torch.parallel.mesh import fetch_global
    from sylber_tpu_torch.train.loop import train

    for fn in counters:
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(recipe, out_dir=str(out_dir), max_steps=MESH_STEPS, log_every=1,
                  ckpt_every=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rows = [json.loads(ln) for ln in open(Path(out_dir) / "metrics.jsonl")]
    rows = [r for r in rows if r["prefix"] == "train"]
    if len(rows) != MESH_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"phase 11 {label}: {len(rows)} metric rows or a loss not finite")
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])][MESH_WARM - 1:]
    params = fetch_global(state.student.state_dict(), state.mesh)
    rec = dict(label=label, step_ms_p50=float(np.median(step_ms)), step_ms=step_ms,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=[r["loss"] for r in rows], launches=launches, wall_s=wall)
    log(f"phase 11 {label}: step p50 {rec['step_ms_p50']:.1f} ms (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}), max_memory_allocated {rec['max_memory_allocated_gb']:.2f} GB, "
        f"loss {rows[0]['loss']:.5g} -> {rows[-1]['loss']:.5g}, launches {launches}  [{smi}]")
    del state
    torch.cuda.empty_cache()
    return rec, params


def world1_phase(torch, counters, smi, tmp):
    """Phase 6's bf16 recipe at world size 1 over NCCL: no process group,
    ``mesh: {dp: 1}`` and ``{dp: 1, fsdp: true}`` (cuDNN deterministic in
    all three, so that the first two can be compared bit for bit)."""
    import torch.distributed as dist

    recipe = stage2_recipe("bfloat16", "default", 100)
    runs, params = {}, {}
    with deterministic_cudnn(torch):
        runs["no_group"], params["no_group"] = world1_run(torch, counters, "no process group",
                                                          recipe, tmp / "w1_none", smi)
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "w1_store"), 1),
                                rank=0, world_size=1)
        try:
            for name, mesh in (("dp1", {"dp": 1}), ("dp1_fsdp", {"dp": 1, "fsdp": True})):
                runs[name], params[name] = world1_run(
                    torch, counters, f"mesh {mesh} over NCCL (world 1)", dict(recipe, mesh=mesh),
                    tmp / f"w1_{name}", smi)
        finally:
            dist.destroy_process_group()
    ref = params["no_group"]
    bit_equal = all(torch.equal(ref[k], params["dp1"][k]) for k in ref)
    largest = max(float(v.abs().max()) for v in ref.values())
    fsdp_err = max(float((ref[k] - params["dp1_fsdp"][k]).abs().max()) for k in ref)
    fsdp_bits = all(torch.equal(ref[k], params["dp1_fsdp"][k]) for k in ref)
    rep = dict(runs=runs, dp1_bit_equal=bit_equal, fsdp_bit_equal=fsdp_bits,
               fsdp_max_abs_err=fsdp_err, param_largest=largest,
               fsdp_tol=MESH_FSDP_REL_TOL * largest)
    base = runs["no_group"]["step_ms_p50"]
    for name in ("dp1", "dp1_fsdp"):
        r = runs[name]
        log(f"phase 11 world 1 {name}: step p50 {r['step_ms_p50']:.1f} ms against "
            f"{base:.1f} without a process group ({r['step_ms_p50'] - base:+.1f} ms), peak "
            f"memory {r['max_memory_allocated_gb']:.2f} against "
            f"{runs['no_group']['max_memory_allocated_gb']:.2f} GB  [{smi}]")
    log(f"phase 11 world 1: dp=1 parameters after {MESH_STEPS} steps bit-equal to the run "
        f"without a process group: {bit_equal}; FSDP max |diff| {fsdp_err:.3g} (tol "
        f"{rep['fsdp_tol']:.3g}), bit-equal {fsdp_bits}")
    if not bit_equal or fsdp_err > rep["fsdp_tol"]:
        raise AssertionError(f"phase 11 world 1: bit-equal {bit_equal}, FSDP err {fsdp_err}")
    return rep


def gloo_recipe():
    """Phase 6's recipe at fp32 "highest", dropout 0, global B8 x 5 s."""
    recipe = stage2_recipe("float32", "highest", GLOO_BATCH)
    recipe["model"]["hubert"] = {"hidden_dropout": 0.0, "attention_dropout": 0.0,
                                 "activation_dropout": 0.0}
    return recipe


def gloo_steps(torch, recipe, mesh=None, fsdp=False, card=0):
    """``GLOO_STEPS`` steps of ``recipe`` on ``cuda:card`` (this rank's rows
    under ``mesh``): the losses, the kernels' launches, the whole
    parameters."""
    from sylber_tpu_torch import ops
    from sylber_tpu_torch.parallel.mesh import fetch_global, shard_batch
    from sylber_tpu_torch.train.distill import init_train_state, make_train_step
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train_batches

    counters = [ops.frontend.conv0_gn_gelu, ops.smallattn.small_attention,
                ops.flash.flash_attention, ops.segment.segment_pass1, ops.segment.segment_pass2]
    dev = torch.device("cuda", card)
    dcfg = distill_config_from_dict(recipe["model"])
    state = init_train_state(dcfg, dev, thresholder_kwargs=recipe["model"]["thresholder_configs"],
                             seed=0, mesh=mesh, fsdp=fsdp)
    stream = train_batches(recipe["data"], GLOO_BATCH, recipe["seed"], 0, dev)
    step = make_train_step(dcfg, mesh)
    for fn in counters:
        fn.launches = 0
    losses = [float(step(state, shard_batch(next(stream), mesh), recipe["seed"])["loss"])
              for _ in range(GLOO_STEPS)]
    launches = {fn.__name__: fn.launches for fn in counters}
    params = fetch_global(state.student.state_dict(), mesh)
    return dict(losses=losses, launches=launches, params=params)


def gloo_probe(rank, world):
    """Whether gloo takes the collectives FSDP needs on CUDA tensors: the
    decision, made before the runs (a refusal here is an answer)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device="cuda:0")
    try:
        out = torch.empty(2, device="cuda:0")
        dist.reduce_scatter_tensor(out, x)
        full = torch.empty(4, device="cuda:0")
        dist.all_gather_into_tensor(full, out)
        return bool((full == 2).all())
    except (RuntimeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def gloo_world(rank, world, cases):
    """Each of ``cases`` ((label, dp, mp, fsdp)) on two ranks sharing cuda:0
    over gloo; rank 0 returns the parameters."""
    import torch

    from sylber_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    out = {}
    for label, dp, mp, fsdp in cases:
        print(f"phase 11 gloo rank {rank}: {label}", flush=True)
        rec = gloo_steps(torch, gloo_recipe(), make_mesh(dp, mp, device_type="cuda"), fsdp)
        if rank:
            rec.pop("params")
        out[label] = rec
    return out


def check_exact_runs(label, ranks, ref, cases):
    """Each of ``cases`` of ``ranks`` (rank 0's parameters) against the
    one-process steps ``ref``: the losses within ``GLOO_LOSS_RTOL``, the
    parameters within ``GLOO_PARAM_ATOL``, the segmentation and the
    teacher's kernels launched on every rank. Returns (runs, launches)."""
    runs, launches = {}, {}
    for case, *_ in cases:
        got = ranks[0][case]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        err = max(float((got["params"][k] - ref["params"][k]).abs().max()) for k in ref["params"])
        ok = rel <= GLOO_LOSS_RTOL and err <= GLOO_PARAM_ATOL
        per_rank = [r[case]["launches"] for r in ranks]
        runs[case] = dict(losses=got["losses"], loss_rel_err=rel, param_max_abs_err=err,
                          launches_by_rank=per_rank, ok=ok)
        for r in per_rank:
            for k, v in r.items():
                launches[k] = launches.get(k, 0) + v
        log(f"phase 11 {label} {case} (fp32 highest, global B{GLOO_BATCH} x 5 s, "
            f"{GLOO_STEPS} steps): losses {['%.7g' % v for v in got['losses']]} against "
            f"one process {['%.7g' % v for v in ref['losses']]} (rel {rel:.2g}, tol "
            f"{GLOO_LOSS_RTOL}), parameters max |diff| {err:.3g} (tol {GLOO_PARAM_ATOL}); "
            f"launches by rank {per_rank} ok={ok}")
        if not ok:
            raise AssertionError(f"phase 11 {label} {case}: {runs[case]}")
        idle = [k for k in ("conv0_gn_gelu", "small_attention", "segment_pass1",
                            "segment_pass2") if any(r[k] == 0 for r in per_rank)]
        if idle:
            raise AssertionError(f"phase 11 {label} {case}: kernels never launched on a "
                                 f"rank: {idle}")
    return runs, launches


def gloo_phase(torch, smi, tmp):
    """dp=2 and mp=2 (and FSDP where gloo allows it) on two ranks sharing
    the card, against the one-process steps on the same global batch."""
    from sylber_tpu_torch.parallel.launch import spawn

    probe = spawn(gloo_probe, 2, str(tmp / "worlds"))[0]
    cases = [("dp2", 2, 1, False), ("mp2", 1, 2, False)]
    if probe is True:
        cases.append(("dp2_fsdp", 2, 1, True))
    log(f"phase 11 gloo on one card: FSDP's collectives on CUDA tensors: "
        f"{'available' if probe is True else probe}; runs: {[c[0] for c in cases]}")
    t0 = time.perf_counter()
    ranks = spawn(gloo_world, 2, str(tmp / "worlds"), cases)
    wall = time.perf_counter() - t0
    ref = gloo_steps(torch, gloo_recipe())
    runs, launches = check_exact_runs("gloo (2 ranks on cuda:0)", ranks, ref, cases)
    return dict(fsdp_probe=probe, cases=[c[0] for c in cases], wall_s=wall,
                one_process_losses=ref["losses"], runs=runs, launches=launches)


NCCL_EXACT = [("dp2", 2, 1, False), ("dp2_fsdp", 2, 1, True)]


def nccl_world(rank, world, recipe, out_dir):
    """Phase 6's recipe at dp=2 over NCCL, one card a rank: ``train()`` for
    ``MESH_STEPS`` steps, then one profiled step (the NCCL kernels' share);
    then the gloo phase's exact runs (``NCCL_EXACT``) over NCCL (rank 0
    returns their parameters)."""
    import torch

    from sylber_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from sylber_tpu_torch.train.distill import make_train_step
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train, train_batches

    state = train(recipe, out_dir=out_dir, max_steps=MESH_STEPS, log_every=1, ckpt_every=0)
    dev = torch.device("cuda", rank)
    mesh = state.mesh
    dcfg = distill_config_from_dict(recipe["model"])
    step = make_train_step(dcfg, mesh)
    batch = shard_batch(next(train_batches(recipe["data"], recipe["data"]["batch_size"],
                                           recipe["seed"], MESH_STEPS, dev)), mesh)
    torch.distributed.barrier()   # both ranks enter the profiled step together, so that
    torch.cuda.synchronize()      # NCCL's kernels do not count one rank's wait for the other
    prof = profile(torch, lambda: step(state, batch, recipe["seed"]), top=40)
    out = dict(device_ms=prof["device_ms"], nccl_ms=prof["nccl_busy_ms"],
               wall_ms=prof["wall_ms"], peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del state
    for case, dp, mp, fsdp in NCCL_EXACT:
        rec = gloo_steps(torch, gloo_recipe(), make_mesh(dp, mp, device_type="cuda"), fsdp,
                         card=rank)
        if rank:
            rec.pop("params")
        out[case] = rec
    return out


def nccl_phase(torch, smi, tmp):
    """dp=2 across two cards, where the machine has them."""
    from sylber_tpu_torch.parallel.launch import spawn

    n = torch.cuda.device_count()
    if n < 2:
        log(f"phase 11 NCCL across cards: the machine has {n} card; not run")
        return dict(cards=n, run=False)
    recipe = dict(stage2_recipe("bfloat16", "default", 100), mesh={"dp": 2})
    out_dir = tmp / "nccl_dp2"
    ranks = spawn(nccl_world, 2, str(tmp / "worlds"), recipe, str(out_dir), backend="nccl")
    rows = [json.loads(ln) for ln in open(out_dir / "metrics.jsonl")]
    rows = [r for r in rows if r["prefix"] == "train"]
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])][MESH_WARM - 1:]
    p50 = float(np.median(step_ms))
    share = [r["nccl_ms"] / r["device_ms"] for r in ranks]
    log(f"phase 11 NCCL dp=2 across 2 cards (global B100 x 5 s bf16): step p50 {p50:.1f} ms; "
        f"NCCL's kernels' busy share of a profiled step's device time by rank "
        f"{['%.3f' % s for s in share]}  [{smi}]")
    runs, launches = check_exact_runs("NCCL (cuda:0 and cuda:1)", ranks,
                                      gloo_steps(torch, gloo_recipe()), NCCL_EXACT)
    for r in ranks:
        for case, *_ in NCCL_EXACT:
            r.pop(case)
    return dict(cards=n, run=True, step_ms_p50=p50, step_ms=step_ms, nccl_share=share,
                ranks=ranks, exact_runs=runs, launches=launches)


def segmenter_mesh_phase(torch, Segmenter, HubertConfig, counters, smi,
                         devices=("cuda:0", "cuda:0")):
    """A mesh of two replicas on ``devices`` against the plain ``Segmenter``
    on the first (the same seeded weights) on phase 3's batches and a 60 s
    long-form call: fp32 "highest" segments equal, bf16 boundary F1 at
    tolerance 0 at least ``MESH_F1_GATE``. Long-form over the mesh takes the
    non-resident path, so its yardstick is a one-replica mesh."""
    from sylber_tpu_torch.longform import LongFormSegmenter
    from sylber_tpu_torch.parallel.mesh import make_mesh
    from sylber_tpu_torch.utils.metrics import boundary_f1

    rng = np.random.RandomState(1)
    batches = {"small_32x5s": [speechlike(rng, 5 * 16000) for _ in range(32)],
               "flash_32x12-20s": [speechlike(rng, int(rng.uniform(12, 20) * 16000))
                                   for _ in range(32)]}
    long_wav = speechlike(np.random.RandomState(11), 60 * 16000)
    modes = {"fp32_highest": HubertConfig(),
             "bf16_default": HubertConfig(dtype="bfloat16", frontend_dtype="bfloat16",
                                          precision="default")}
    rep, launches = {}, {fn.__name__: 0 for fn in counters}
    for mode, cfg in modes.items():
        plain = Segmenter(hubert_config=cfg, device=devices[0])
        dp = Segmenter(hubert_config=cfg, mesh=make_mesh(2, devices=list(devices)))
        one = Segmenter(hubert_config=cfg, mesh=make_mesh(1, devices=[devices[0]]))
        calls = {name: (plain.process, dp.process, wavs) for name, wavs in batches.items()}
        calls["longform_60s"] = (lambda w: [LongFormSegmenter(one)(wav=w[0], in_second=False)],
                                 lambda w: [LongFormSegmenter(dp)(wav=w[0], in_second=False)],
                                 [long_wav])
        for name, (ref_fn, dp_fn, wavs) in calls.items():
            lf = name == "longform_60s"
            call = lambda fn: fn(wavs) if lf else fn(wavs, in_second=False)  # noqa: E731
            want = call(ref_fn)
            call(dp_fn)  # warm-up
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            got = call(dp_fn)
            for fn in counters:
                launches[fn.__name__] += fn.launches
            walls = {"ref": [], "mesh": []}  # in turns: ref, mesh, mesh, ref
            for side in ("ref", "mesh", "mesh", "ref"):
                t0 = time.perf_counter()
                call(ref_fn if side == "ref" else dp_fn)
                walls[side].append(time.perf_counter() - t0)
            equal = sum(a["segments"].tolist() == b["segments"].tolist()
                        for a, b in zip(got, want))
            f1 = float(np.mean([boundary_f1(a["segments"], b["segments"], tol_frames=0)
                                for a, b in zip(got, want)]))
            ok = equal == len(want) if mode == "fp32_highest" else f1 >= MESH_F1_GATE
            audio_s = sum(len(w) for w in wavs) / 16000.0
            rtfx = {k: audio_s / float(np.mean(v)) for k, v in walls.items()}
            rep[f"{mode}/{name}"] = dict(items=len(want), equal=equal, boundary_f1_tol0=f1,
                                         rtfx_mesh=rtfx["mesh"], rtfx_reference=rtfx["ref"],
                                         ok=ok)
            ref_name = "a one-replica mesh" if lf else "the plain Segmenter"
            log(f"phase 11 Segmenter mesh of 2 replicas on {'+'.join(devices)}, {mode} {name}: "
                f"{equal} of "
                f"{len(want)} items' segments equal to {ref_name}'s, boundary F1 (tol 0) "
                f"{f1:.5f} ok={ok}; RTFx (mean of 2 calls, in turns) {rtfx['mesh']:.1f} against "
                f"{rtfx['ref']:.1f} for {ref_name}  [{smi}]")
            if not ok:
                raise AssertionError(f"phase 11 Segmenter mesh on {devices} {mode} {name}: {rep}")
        del plain, dp, one
        torch.cuda.empty_cache()
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"phase 11 Segmenter mesh on {devices}: kernels never launched: "
                             f"{idle}")
    return dict(devices=list(devices), calls=rep, launches=launches)


def two_card_phases(torch, Segmenter, HubertConfig, counters, smi, tmp):
    """What phase 11 runs only where there are two cards: dp=2 over NCCL
    across them, and the Segmenter's replicas on cuda:0 and cuda:1 (each
    replica's kernels launched on its own card); None for either on a
    machine with one card."""
    nccl = nccl_phase(torch, smi, tmp)
    if torch.cuda.device_count() < 2:
        log("phase 11 Segmenter mesh across cards: the machine has one card; not run")
        return nccl, None
    return nccl, segmenter_mesh_phase(torch, Segmenter, HubertConfig, counters, smi,
                                      devices=("cuda:0", "cuda:1"))


def mesh_phase(torch, Segmenter, HubertConfig, counters, smi):
    """Phase 11: the mesh. Any failed check raises."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        world1 = world1_phase(torch, counters, smi, tmp)
        t1 = time.perf_counter()
        gloo = gloo_phase(torch, smi, tmp)
        t2 = time.perf_counter()
        nccl, seg2 = two_card_phases(torch, Segmenter, HubertConfig, counters, smi, tmp)
        seg = segmenter_mesh_phase(torch, Segmenter, HubertConfig, counters, smi)
        t3 = time.perf_counter()
    launches = {fn.__name__: 0 for fn in counters}
    for part in [*(r["launches"] for r in world1["runs"].values()), gloo["launches"],
                 seg["launches"], *([seg2["launches"]] if seg2 else []),
                 *([nccl["launches"]] if nccl["run"] else [])]:
        for k, v in part.items():
            launches[k] += v
    log(f"phase 11: world 1 {t1 - t0:.1f} s, gloo {t2 - t1:.1f} s, NCCL and the Segmenter "
        f"{t3 - t2:.1f} s; launches over the phase's paths {launches}  [{smi}]")
    return dict(world1=world1, gloo=gloo, nccl=nccl, segmenter=seg, segmenter_two_cards=seg2,
                launches=launches)


# the gates of --reproduce-distill, set before its first run: JAX's recorded
# boundary F1 against the truth (0.9187) less 0.04, since the port's draws
# differ from JAX's by design (ROADMAP.md record (n)); and the fast mode's gate
REPRODUCE_F1_GATE = 0.88


# ---------------------------------------------------------------- phase 12

DISPATCH_K, DISPATCH_WARM, DISPATCH_STEPS = 8, 8, 24  # the first dispatch untimed
EMA_STEPS = 5
# full width, fp32 "highest": conv 0's bias cancels in its GroupNorm, so the
# kernel without it and the standard path with it differ by rounding only
LAYER0_BIAS_TOL = 1e-3


def host_launches(torch, prof) -> dict:
    """The host's launch calls in a profiled region, by name (the CUDA
    runtime's and driver's kernel launches, graph launches and copies)."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cu") and any(
                t in e.name for t in ("Launch", "Memcpy", "Memset")):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def dispatch_runs(torch, counters, smi, tmp):
    """Phase 6's bf16 recipe (B100 x 5 s) with cuDNN deterministic through
    ``train()``: K 1 and K 8 (``steps_per_dispatch``), ``DISPATCH_STEPS``
    steps each with every row logged (K 8 fetches a dispatch's rows at its
    end), and K 1 again logging every 8th step (one wait in 8 steps, as K
    8); the K 8 run's launches from 0 with each kernel's launches in the
    captured step. Then on its state: one dispatch under
    ``set_sync_debug_mode("error")``, one profiled dispatch and one profiled
    one-step step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from sylber_tpu_torch.train import loop as L
    from sylber_tpu_torch.train.distill import make_train_step
    from sylber_tpu_torch.train.loop import distill_config_from_dict

    made = []

    class Recorded(L.StepDispatch):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.per_replay = {}
            made.append(self)

        def _capture(self, state):
            before = {fn.__name__: fn.launches for fn in counters}
            graph = super()._capture(state)
            self.per_replay = {fn.__name__: fn.launches - before[fn.__name__]
                               for fn in counters}
            return graph

    recipe = stage2_recipe("bfloat16", "default", 100)
    runs, params = {}, {}
    saved = L.StepDispatch
    L.StepDispatch = Recorded
    try:
        with deterministic_cudnn(torch):
            for name, k, log_every in (("k1", 1, 1), ("k8", DISPATCH_K, 1),
                                       ("k1_log8", 1, DISPATCH_K)):
                for fn in counters:
                    fn.launches = 0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                state = L.train(dict(recipe, steps_per_dispatch=k), out_dir=str(tmp / name),
                                max_steps=DISPATCH_STEPS, log_every=log_every, ckpt_every=0,
                                device="cuda")
                torch.cuda.synchronize()
                rows = [json.loads(ln) for ln in open(tmp / name / "metrics.jsonl")]
                rows = [r for r in rows if r["prefix"] == "train"]
                times = {r["step"]: r["time"] for r in rows}
                ends = [s for s in range(DISPATCH_WARM, DISPATCH_STEPS + 1, DISPATCH_K)]
                if name == "k1":
                    step_ms = [1e3 * (times[s + 1] - times[s])
                               for s in range(DISPATCH_WARM, DISPATCH_STEPS)]
                else:  # a dispatch's (or 8 steps') wall over 8
                    step_ms = [1e3 * (times[b] - times[a]) / DISPATCH_K
                               for a, b in zip(ends, ends[1:])]
                rec = dict(steps_per_dispatch=k, log_every=log_every, step_ms=step_ms,
                           step_ms_p50=float(np.median(step_ms)),
                           max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                           launches={fn.__name__: fn.launches for fn in counters},
                           rows={r["step"]: {m: r[m] for m in ("loss", "grad_norm",
                                                               "normthreshold",
                                                               "num_segments")}
                                 for r in rows})
                if k > 1:
                    disp = made[-1]
                    rec.update(capture_s=disp.capture_s, replays=disp.replays,
                               eager_steps=disp.eager_steps,
                               launches_per_replay=disp.per_replay)
                runs[name] = rec
                log(f"phase 12 {name}: B100 x 5 s bf16, {DISPATCH_STEPS} steps, K {k}, rows "
                    f"every {log_every}: step p50 {rec['step_ms_p50']:.1f} ms over "
                    f"{len(step_ms)} {'steps' if name == 'k1' else 'spans of 8 steps'} after "
                    f"{DISPATCH_WARM} (min {min(step_ms):.1f}, max {max(step_ms):.1f}); "
                    f"max_memory_allocated {rec['max_memory_allocated_gb']:.2f} GB; launches "
                    f"{rec['launches']}"
                    + (f"; capture {rec['capture_s']:.2f} s, {rec['replays']} replays, "
                       f"{rec['eager_steps']} eager steps, each kernel's launches in the "
                       f"captured step {rec['launches_per_replay']}" if k > 1 else "")
                    + f"  [{smi}]")
                if name == "k1_log8":
                    del state
                    continue
                params[name] = {n: p.detach().cpu() for n, p in
                                state.student.state_dict().items()}
                if name == "k8":
                    kept = state
                del state
            state, disp = kept, made[-1]
            seed = recipe["seed"]
            order = np.random.RandomState(5).permutation(100)
            idx = np.stack([np.roll(order, i) for i in range(DISPATCH_K)])
            disp.dispatch(state, seed, idx)
            torch.cuda.synchronize()
            disp._done = None  # the host's wait for the dispatch before lies outside
            forbid_host_syncs(torch, disp.dispatch)(state, seed, idx)  # raises on a host sync
            torch.cuda.synchronize()
            disp._done = None
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                disp.dispatch(state, seed, idx)
                torch.cuda.synchronize()
            host = host_launches(torch, prof)
            disp._done = None
            dprof = profile(torch, lambda: disp.dispatch(state, seed, idx), top=6)
            step_fn = make_train_step(distill_config_from_dict(
                dict(recipe["model"], accumulate_grad_batches=1)))
            batch = {k: v.index_select(0, torch.as_tensor(order, device="cuda"))
                     for k, v in disp.data.items()}
            batch.update({k: None for k in disp.absent})
            step_fn(state, batch, seed)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof1:
                step_fn(state, batch, seed)
                torch.cuda.synchronize()
            host1 = host_launches(torch, prof1)
            sprof = profile(torch, lambda: step_fn(state, batch, seed), top=6)
            del state, kept, disp, made[:]
            torch.cuda.empty_cache()
    finally:
        L.StepDispatch = saved
    idle = [n for n in ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2")
            if runs["k8"]["launches"][n] == 0 or runs["k8"]["launches_per_replay"][n] == 0]
    if idle:
        raise AssertionError(f"phase 12: kernels never launched in the K {DISPATCH_K} run, or "
                             f"not in its captured step: {idle}")
    a, b = runs["k1"]["rows"], runs["k8"]["rows"]
    rows_equal = a == b
    pa, pb = params["k1"], params["k8"]
    bit_equal = all(torch.equal(pa[k], pb[k]) for k in pa)
    max_diff = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    rep = dict(runs=runs, rows_bit_equal=rows_equal, params_bit_equal=bit_equal,
               params_max_abs_diff=max_diff,
               host_launches_per_dispatch=host, host_launches_per_step_k1=host1,
               dispatch_profile=dprof, step_profile=sprof,
               idle_share_dispatch=1.0 - dprof["device_ms"] / dprof["wall_ms"],
               idle_share_step=1.0 - sprof["device_ms"] / sprof["wall_ms"])
    log(f"phase 12: K {DISPATCH_K} against K 1 over {DISPATCH_STEPS} steps: losses, grad "
        f"norms, norm thresholds and segment counts of every step bit-equal {rows_equal}; "
        f"parameters bit-equal {bit_equal} (max |diff| {max_diff:.3g}); a dispatch under "
        f"set_sync_debug_mode('error'): no host sync")
    log(f"phase 12: host launches a dispatch of {DISPATCH_K} steps {sum(host.values())} "
        f"({host}); a one-step step {sum(host1.values())}; profiled dispatch: device busy "
        f"{dprof['device_ms']:.1f} of {dprof['wall_ms']:.1f} ms (idle share "
        f"{rep['idle_share_dispatch']:.4f}), {dprof['launches']} device events; one-step "
        f"step: busy {sprof['device_ms']:.1f} of {sprof['wall_ms']:.1f} ms (idle share "
        f"{rep['idle_share_step']:.4f})  [{smi}]")
    if not (rows_equal and bit_equal):
        raise AssertionError(f"phase 12: K {DISPATCH_K} is not K 1: rows equal {rows_equal}, "
                             f"parameters max |diff| {max_diff}")
    return rep


def conv0_other_taps_record(torch, ops, k=8, s=4, B=32, L=80000, D=512):
    """conv0 + GroupNorm + GELU at taps ``k`` and stride ``s`` (the
    runtime-shaped kernels) on B x L, both output dtypes: against the plain
    version, timed beside it, the library form and the bound."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(B, L, device="cuda", generator=gen)
    w = torch.randn(D, 1, k, device="cuda", generator=gen) / k ** 0.5
    gamma = torch.rand(D, device="cuda", generator=gen) + 0.5
    beta = 0.1 * torch.randn(D, device="cuda", generator=gen)
    T0 = (L - k) // s + 1
    rec = {}
    for dt, tol in (("float32", 2e-4), ("bfloat16", 2e-2)):
        tdt = getattr(torch, dt)
        run = lambda: ops.frontend.conv0_gn_gelu(x, w, gamma, beta, stride=s,  # noqa: E731
                                                 out_dtype=tdt)
        plain = lambda: ops.frontend.conv0_gn_gelu_plain(x, w, gamma, beta, stride=s,  # noqa: E731
                                                         out_dtype=tdt)
        library = lambda: F.gelu(F.group_norm(F.conv1d(x[:, None], w, stride=s), D,  # noqa: E731
                                              gamma, beta)).to(tdt)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        nbytes = 4 * (B * L + D * (k + 2)) + B * T0 * D * got.element_size()
        del got, want
        b_ms, b_by = bound_ms(nbytes, B * T0 * D * (2 * k + 4), "float32")
        rec[dt] = dict(max_abs_err=err, tol=tol, ok=bool(ok), ms=graph_time_ms(torch, run, 5),
                       plain_ms=time_ms(torch, plain, 5), library_ms=time_ms(torch, library, 5),
                       eager_ms=time_ms(torch, run, 10), bound_ms=b_ms, bound_by=b_by,
                       shape=[B, L, D, k, s])
        torch.cuda.empty_cache()
    return rec


CONV0_OTHER_EDGES = [(6, 3, 3, 1001, 72), (13, 7, 2, 4003, 40), (20, 10, 2, 9000, 24),
                     (32, 16, 1, 48, 8), (8, 4, 2, 12, 8)]  # k, s, B, L, D


def conv0_other_taps_edges(torch, ops):
    """The runtime-shaped conv0 kernels at other taps (each rounding of k up
    to 4, k at its largest, two frames) against the plain version, both
    output dtypes."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    for k, s, B, L, D in CONV0_OTHER_EDGES:
        x = torch.randn(B, L, device="cuda", generator=gen)
        w = torch.randn(D, 1, k, device="cuda", generator=gen) / k ** 0.5
        gamma = torch.rand(D, device="cuda", generator=gen) + 0.5
        beta = 0.1 * torch.randn(D, device="cuda", generator=gen)
        for dt, tol in (("float32", 2e-4), ("bfloat16", 2e-2)):
            tdt = getattr(torch, dt)
            got = ops.frontend.conv0_gn_gelu(x, w, gamma, beta, stride=s, out_dtype=tdt).float()
            want = ops.frontend.conv0_gn_gelu_plain(x, w, gamma, beta, stride=s,
                                                    out_dtype=tdt).float()
            err = (got - want).abs().max().item()
            out.append(dict(taps=k, stride=s, shape=[B, L, D], dtype=dt, max_abs_err=err,
                            tol=tol, ok=bool(torch.allclose(got, want, rtol=tol, atol=tol))))
    return out


def conv_bias_segmenter(torch, Segmenter, HubertConfig, counters, smi):
    """A full-width Segmenter with ``conv_bias=True`` (every conv bias drawn
    non-zero) on 32 x 5 s, fp32 "highest": conv0's kernel launched (launches
    from 0); the hidden states within ``LAYER0_BIAS_TOL`` of the same
    Segmenter whose layer 0 takes the standard fp32 conv (with the bias) +
    GroupNorm + exact GELU, and the same segments."""
    import sylber_tpu_torch.models.hubert as H

    rng = np.random.RandomState(1)
    wavs = [speechlike(rng, 5 * 16000) for _ in range(32)]
    seg = Segmenter(hubert_config=HubertConfig(conv_bias=True))
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for conv in seg.model.feature_extractor.convs:
            conv.bias.normal_(0.0, 0.5, generator=gen)
    seg.process(wavs, in_second=False)
    for fn in counters:
        fn.launches = 0
    outs = seg.process(wavs, in_second=False)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    cfg, fused = seg.config, H.conv0_gn_gelu

    def standard(x, w, gamma, beta, *, stride, eps, out_dtype):
        return H.conv0_standard(x, w, seg.model.feature_extractor.convs[0].bias, gamma, beta,
                                cfg)

    H.conv0_gn_gelu = standard
    try:
        want = seg.process(wavs, in_second=False)
    finally:
        H.conv0_gn_gelu = fused
    err = max(float(np.abs(a["hidden_states"] - b["hidden_states"]).max())
              for a, b in zip(outs, want))
    same = all(np.array_equal(a["segments"], b["segments"]) for a, b in zip(outs, want))
    rec = dict(launches=launches, max_abs_err=err, tol=LAYER0_BIAS_TOL, segments_equal=same,
               segments=int(sum(len(o["segments"]) for o in outs)))
    log(f"phase 12 conv_bias=True Segmenter, 32 x 5 s fp32: launches {launches}; hidden states "
        f"against the standard layer 0 with its bias max |diff| {err:.3g} (tol "
        f"{LAYER0_BIAS_TOL}), segments equal {same} ({rec['segments']} segments)  [{smi}]")
    del seg
    torch.cuda.empty_cache()
    if launches["conv0_gn_gelu"] == 0 or err > LAYER0_BIAS_TOL or not same:
        raise AssertionError(f"phase 12 conv_bias: {rec}")
    return rec


def bf16_regressor_runs(torch, counters, smi):
    """Phase 7's 8 x 5 s resynthesis at "default" precision, midpoint with 5
    steps, cond_scale 1, with the regressor in float32 and in bfloat16
    (``RegressorConfig.dtype``): wav -> wav RTFx of five calls each, the
    cosine of the bf16 articulatory output to the fp32 one; the bf16 run's
    launches from 0 (conv0, small attention and both segmentation passes
    must launch); the GateLoop layers in bf16 run once (the GateLoop kernel
    must launch). Seeded random weights, the same in every run."""
    import dataclasses
    import warnings

    import yaml

    from sylber_tpu_torch.synthesis import SegmentSynthesis, SynthesisConfig
    from sylber_tpu_torch.vocoder import SparcDecoder

    yaml_cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    base = SynthesisConfig.from_yaml_dict(yaml_cfg)
    wavs = [speechlike(np.random.RandomState(7), 5 * 16000) for _ in range(8)]
    wav_np, spk = np.stack(wavs), np.zeros((8, 64), np.float32)
    dev = torch.device("cuda")
    vocoder = SparcDecoder(device=dev)
    runs, arts = {}, {}
    for name, dtype, gated in (("float32", "float32", False), ("bfloat16", "bfloat16", False),
                               ("bfloat16_gateloop", "bfloat16", True)):
        cfg = dataclasses.replace(base, regressor=dataclasses.replace(
            base.regressor, dtype=dtype, use_gateloop_layers=gated))
        synth = SegmentSynthesis(config=cfg, thresholder_configs=yaml_cfg["thresholder_configs"],
                                 device=dev)

        def call():
            art, segs = synth.resynthesize(input_values=wav_np, steps=5)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # random-init vocoder: noise, not speech
                return art, segs, synth.decode_audio(art, spk, vocoder=vocoder)

        call()  # warm-up
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        walls = []
        for _ in range(1 if gated else 5):
            t0 = time.perf_counter()
            art, segs, audio = call()
            walls.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        check_resynthesis_outputs(art, segs, audio, wavs, cfg)
        rtfx = sorted(wav_np.size / 16000.0 / w for w in walls)
        arts[name] = art.astype(np.float64)
        runs[name] = dict(rtfx=rtfx[len(rtfx) // 2], wall_s=walls, launches=launches)
        del synth
        torch.cuda.empty_cache()
    a, b = arts["float32"].reshape(8, -1), arts["bfloat16"].reshape(8, -1)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    rep = dict(runs=runs, cosine_bf16_fp32=[float(c) for c in cos],
               max_abs_diff=float(np.abs(a - b).max()), largest=float(np.abs(a).max()))
    log(f"phase 12 resynthesis 8 x 5 s, regressor float32 / bfloat16: RTFx median of 5 "
        f"{runs['float32']['rtfx']:.1f} / {runs['bfloat16']['rtfx']:.1f}; cosine of the bf16 "
        f"articulatory output to fp32's per item min {cos.min():.5f} (max |diff| "
        f"{rep['max_abs_diff']:.3g} of {rep['largest']:.3g}); bf16 launches "
        f"{runs['bfloat16']['launches']}; GateLoop layers in bf16, one call: RTFx "
        f"{runs['bfloat16_gateloop']['rtfx']:.1f}, launches "
        f"{runs['bfloat16_gateloop']['launches']}  [{smi}]")
    need = {"bfloat16": ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2"),
            "bfloat16_gateloop": ("gate_loop_operator",)}
    idle = [(n, k) for n, ks in need.items() for k in ks if runs[n]["launches"][k] == 0]
    if idle or not np.isfinite(cos).all():
        raise AssertionError(f"phase 12 bf16 regressor: idle {idle}, cosine {cos}")
    return rep


def regressor_attention_bf16_records(torch, ops):
    """Both attention kernels at the bf16 regressor's shapes: its core is the
    float32 kernels (JAX promotes q and k to float32: the RMS norms' gammas
    and the rotary angles are float32) on a bf16-rounded v; beside them the
    bf16 kernels on the same q, k, v rounded to bf16, the form the core is
    not given, with their gap to the float32 plain version (the scale of 10
    magnifies the rounding of q and k). Times, bounds, plain versions and
    SDPA as ``regressor_attention_records``."""
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
        v = v.bfloat16().float()
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        want = plain_fn(q, k, v, lens, scale)
        rec = {}
        for dt in ("float32", "bfloat16"):
            tq, tk, tv = (t.to(getattr(torch, dt)) for t in (q, k, v))
            run = lambda: fn(tq, tk, tv, lens, scale)  # noqa: E731
            plain = lambda: plain_fn(tq, tk, tv, lens, scale)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(tq, tk, tv, scale=scale)  # noqa: E731
            got, own = run(), plain()
            torch.cuda.synchronize()
            err = (got.float() - own.float()).abs().max().item()
            tol = REGRESSOR_ATTN_TOL if dt == "float32" else 2e-2
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), own.float(), rtol=tol, atol=tol)
            size = 4 if dt == "float32" else 2
            nbytes = size * B * L * H * D * 4 + 4 * B
            b_ms, b_by = bound_ms(nbytes, 4.0 * H * D * L * L * B, dt)
            rec[dt] = dict(max_abs_err=err, tol=tol, ok=ok, scale=scale,
                           gap_to_float32=(got.float() - want).abs().max().item(),
                           ms=graph_time_ms(torch, run, 20), plain_ms=graph_time_ms(torch, plain, 5),
                           library_ms=graph_time_ms(torch, library, 20),
                           eager_ms=time_ms(torch, run, 20), bound_ms=b_ms, bound_by=b_by,
                           shape=[B, H, L, D], on_path=dt == "float32")
        out[name] = rec
    return out


def ema_shadow_runs(torch, smi):
    """Stage 1 of phase 6's bf16 recipe (the synthetic corpus's segments,
    B100 x 5 s) with ``ema_decay`` 0.999, ``EMA_STEPS`` steps with the EMA
    teacher a float32 shadow and without it: step ms (the last four, each
    waited for) and peak memory. The port keeps float32 parameters, as
    flax does, so both teachers are float32 (JAX's rule)."""
    import dataclasses

    from sylber_tpu_torch.train import distill as D
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train_batches

    recipe = stage2_recipe("bfloat16", "default", 100)
    model = dict(recipe["model"], segment_online=False, ema_decay=0.999,
                 accumulate_grad_batches=1)
    data = dict(recipe["data"], segment_online_data=False)
    runs = {}
    for shadow in (True, False):
        cfg = dataclasses.replace(distill_config_from_dict(model), ema_fp32_shadow=shadow)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = D.init_train_state(cfg, "cuda", seed=0)
        step = D.make_train_step(cfg)
        stream = train_batches(data, 100, 0, 0, torch.device("cuda"))
        walls = []
        for _ in range(EMA_STEPS):
            batch = next(stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch, 0)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        dtypes = sorted({str(v.dtype) for v in state.ema.values()})
        runs["shadow" if shadow else "no_shadow"] = dict(
            step_ms=walls, step_ms_p50=float(np.median(walls[1:])),
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            teacher_dtypes=dtypes, loss=float(m["loss"]))
        del state, stream
    a, b = runs["shadow"], runs["no_shadow"]
    log(f"phase 12 ema_decay 0.999, stage 1 bf16 B100 x 5 s, {EMA_STEPS} steps: fp32 shadow / "
        f"none: step p50 {a['step_ms_p50']:.1f} / {b['step_ms_p50']:.1f} ms, "
        f"max_memory_allocated {a['max_memory_allocated_gb']:.2f} / "
        f"{b['max_memory_allocated_gb']:.2f} GB, teacher dtypes {a['teacher_dtypes']} / "
        f"{b['teacher_dtypes']}  [{smi}]")
    return runs


def dispatch_phase(torch, ops, Segmenter, HubertConfig, counters, smi):
    """Phase 12: ``steps_per_dispatch`` as CUDA-graph replay, layer 0 at
    other taps and with a bias, the bf16 regressor, ``ema_fp32_shadow``."""
    counters = counters + [ops.gateloop.gate_loop_operator]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dispatch_") as tmp:
        dispatch = dispatch_runs(torch, counters[:5], smi, Path(tmp))
    from sylber_tpu_torch.models.hubert import matmul_precision

    with matmul_precision("highest"):
        conv0 = conv0_other_taps_record(torch, ops)
        edges = conv0_other_taps_edges(torch, ops)
    log(f"phase 12 conv0_gn_gelu at (k, s) {[(e['taps'], e['stride']) for e in edges[::2]]}, "
        f"fp32 and bf16: {sum(e['ok'] for e in edges)} of {len(edges)} within tolerance, worst "
        f"fp32 {max(e['max_abs_err'] for e in edges if e['dtype'] == 'float32'):.3g}, bf16 "
        f"{max(e['max_abs_err'] for e in edges if e['dtype'] == 'bfloat16'):.3g}")
    for dt, r in conv0.items():
        log(f"phase 12 conv0_gn_gelu (8, 4) {dt} {r['shape']}: max_abs_err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']}) ok={r['ok']}  kernel_ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}"
            f"  library_ms {r['library_ms']:.4f}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
            f"  [{smi}]")
    bias = conv_bias_segmenter(torch, Segmenter, HubertConfig, counters[:5], smi)
    regressor = bf16_regressor_runs(torch, counters, smi)
    attn = regressor_attention_bf16_records(torch, ops)
    for name, rec in attn.items():
        for dt, r in rec.items():
            log(f"phase 12 {name} at the bf16 regressor's shape {r['shape']} with {dt} "
                f"q, k, v ({'its core' if r['on_path'] else 'not its core'}): max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']}) ok={r['ok']}, gap to the float32 "
                f"plain version {r['gap_to_float32']:.3g}; kernel_ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} SDPA {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
                f"({r['bound_by']})  [{smi}]")
    ema = ema_shadow_runs(torch, smi)
    bad = [f"conv0 {dt}" for dt, r in conv0.items() if not r["ok"]] + [
        f"{n} {dt}" for n, rec in attn.items() for dt, r in rec.items() if not r["ok"]] + [
        f"conv0 {e}" for e in edges if not e["ok"]]
    if bad:
        raise AssertionError(f"phase 12: kernels disagree with their plain versions: {bad}")
    rep = dict(dispatch=dispatch, conv0_k8_s4=conv0, conv0_edges=edges, conv_bias=bias,
               bf16_regressor=regressor,
               regressor_attention_bf16=attn, ema_shadow=ema, seconds=time.perf_counter() - t0)
    log(f"phase 12 took {rep['seconds']:.1f} s  [{smi}]")
    return rep


# ---------------------------------------------------------------- phase 13

EVAL_CODEBOOKS = (64, 256, 1024)  # the recorded v1 codebooks (mini_codebook_{K}.npy)
EVAL_UTTS, EVAL_STEPS = 8, 8      # held-out utterances of 5 s (seed 90001), ODE steps
# the card's and the CPU's art each within this of a float64 reference (of the
# largest value): the trained field amplifies float32 rounding, so that the
# CPU's own float32 art sits 3.5e-4 from float64 at km64 (one ulp of the
# conditioning moves it 1.8e-4), past phase 7's 1e-4 card-vs-CPU tolerance
EVAL_F64_RTOL = 5e-4
KM_TIE_RTOL = 1e-4                # a token may differ only at a near-tie of its two codes
CHAIN_KERNELS = ("conv0_gn_gelu", "small_attention", "segment_pass1", "segment_pass2")
VOCODER_PROOF_STEPS = 20          # resumed at half
PRODUCTION_SEEDING = (110109, 144, (5000, 10000, 20000))  # the continuum pool's n, d; the k
PRODUCTION_CLUSTERS = 8500        # the continuum pool's non-empty codes at k 10,000-20,000
# the recorded-codebook reproductions' prediction (PERF.md, written before the first run)
PREDICTED_CORR_GAP, PREDICTED_L1_REL_GAP = 0.02, 0.10


def counted_call(counters, fn):
    """``fn()`` with every counter set to 0 just before it: ``(its result,
    the launches it made)``, read just after it, before any check runs."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def add_launches(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return total


def km_tie_gaps(feats, got, want, centroids):
    """For each segment whose token differs: the gap between the squared
    distances of its two codes, relative to the scale the search computes
    them at (|x|^2 + |c|^2: the expanded form |c|^2 - 2 x.c)."""
    gaps = []
    for i in np.nonzero(got != want)[0]:
        x, c = feats[i].astype(np.float64), centroids[[got[i], want[i]]].astype(np.float64)
        d = ((x[None] - c) ** 2).sum(-1)
        gaps.append(float(abs(d[0] - d[1]) / ((x ** 2).sum() + (c ** 2).sum(-1).max())))
    return gaps


def float64_reference_art(torch, synth, wav, nt, mt, steps):
    """The chain's art on the CPU with the sampler's regressor in float64
    (the conditioning as the float32 chain computes it): the exact answer
    the float32 runs round away from."""
    with torch.inference_mode():
        w = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
        cond, _ = synth.cond_from_wav(w, torch.ones(w.shape, dtype=torch.int32), nt, mt)
        synth.regressor.double()
        try:
            return synth.sample(cond.double(), steps=steps).numpy()
        finally:
            synth.regressor.float()


def token_chain_agreement(torch, counters, smi):
    """The token chain (``token_chain_proof``: wav -> segment -> recorded
    codebook's tokens -> CFM) on ``EVAL_UTTS`` held-out utterances at
    ``EVAL_STEPS`` ODE steps, on the card and on the CPU, the regressor at
    "highest" on both: per codebook the card's ``eval_chain`` with the
    counters from 0 (conv0, small attention and both segmentation passes
    must launch in it), the same tokens (a token may differ only at a
    near-tie, ``KM_TIE_RTOL``) and the card's and the CPU's art each within
    ``EVAL_F64_RTOL`` of the float64 reference (``float64_reference_art``)
    on every utterance whose tokens all agree (at least one), their own gap
    printed; the card's metrics and vocoder leg beside the recorded 50-step
    table (not gated at 8 utterances and 8 steps)."""
    import dataclasses

    from sylber_tpu_torch import token_chain_proof as tcp
    from sylber_tpu_torch.quantizer import KMQuantizer
    from sylber_tpu_torch.train.synthesis_loop import build_synthesis_corpus, eval_chain

    heldout = build_synthesis_corpus(EVAL_UTTS, 5.0, seed=tcp.HELDOUT_SEED)
    recorded = json.loads((FIXTURES / "token_chain.json").read_text())["table"]
    synths = {}
    for dev in ("cuda", "cpu"):
        s, nt, mt = tcp.build_synth(device=dev)
        s.config = dataclasses.replace(s.config, regressor=dataclasses.replace(
            s.config.regressor, precision="highest"))
        synths[dev] = s
    vocoder = tcp.load_vocoder("mini_vocoder", "cuda")
    rows = []
    for K in EVAL_CODEBOOKS:
        cents = np.load(FIXTURES / f"mini_codebook_{K}.npy").astype(np.float32)
        out = {}
        for dev, s in synths.items():
            s.quantizer = KMQuantizer(cents, device=dev)
            t0 = time.perf_counter()
            (art, m), got = counted_call(counters, lambda: eval_chain(
                s, nt, mt, heldout, steps=EVAL_STEPS, batch=EVAL_UTTS))
            out[dev] = dict(art=art, metrics=m, s=time.perf_counter() - t0, launches=got,
                            tokens=segment_tokens(torch, s, heldout["wav"], nt))
        exact = float64_reference_art(torch, synths["cpu"], heldout["wav"], nt, mt, EVAL_STEPS)
        (tg, _, ng), (tc, fc, nc) = out["cuda"]["tokens"], out["cpu"]["tokens"]
        same_count = np.array_equal(ng, nc)
        gaps = km_tie_gaps(fc, tg, tc, cents) if same_count else []
        utt_of = np.repeat(np.arange(len(nc)), nc)
        differ = sorted(set(utt_of[np.nonzero(tg != tc)[0]].tolist())) if same_count else []
        agree = [b for b in range(len(nc)) if b not in differ]
        err = rel_err(out["cuda"]["art"], out["cpu"]["art"])
        card_f64, cpu_f64 = (rel_err(out[d]["art"][agree], exact[agree]) if agree else None
                             for d in ("cuda", "cpu"))
        launches = out["cuda"]["launches"]
        idle = [k for k in CHAIN_KERNELS if launches.get(k, 0) == 0]
        ok = (same_count and all(g <= KM_TIE_RTOL for g in gaps) and bool(agree)
              and max(card_f64, cpu_f64) <= EVAL_F64_RTOL and not idle)
        m = out["cuda"]["metrics"]
        m["vocoder"] = tcp.vocoder_leg(out["cuda"]["art"], heldout, vocoder=vocoder)
        rec = dict(codebook=K, tokens=int(len(tc)), token_differences=len(gaps),
                   relative_distance_gaps=gaps, utterances_compared=len(agree),
                   art_err_of_largest=err, card_err_to_float64=card_f64,
                   cpu_err_to_float64=cpu_f64, launches=launches, idle_kernels=idle,
                   card_s=out["cuda"]["s"], cpu_s=out["cpu"]["s"], metrics=m,
                   recorded=recorded[f"km{K}"], ok=bool(ok))
        rows.append(rec)
        log(f"phase 13 token chain km{K} (recorded codebook, {EVAL_UTTS} x 5 s, {EVAL_STEPS} "
            f"steps) card vs CPU: {rec['tokens']} tokens, {len(gaps)} differ (gaps {gaps}, "
            f"utterances {differ}); art card vs CPU {err:.3g} of the largest, to the float64 "
            f"reference over the {len(agree)} utterances whose tokens agree card {card_f64}"
            f" / CPU {cpu_f64} (tol {EVAL_F64_RTOL} each); the card's eval_chain launched "
            f"{launches} ok={rec['ok']}; card {rec['card_s']:.2f} s, CPU {rec['cpu_s']:.2f} s; "
            f"card pitch_corr {m['pitch_corr']:.4f} loud_corr {m['loud_corr']:.4f} vocoder "
            f"f0_corr {m['vocoder']['f0_corr']:.4f} (recorded at 24 utts, 50 steps: "
            f"{recorded[f'km{K}']['pitch_corr']:.4f} / {recorded[f'km{K}']['loud_corr']:.4f} / "
            f"{recorded[f'km{K}']['vocoder']['f0_corr']:.4f})  [{smi}]")
    return rows


def fit_quantizer_run(torch, counters, smi, tmp):
    """``python -m sylber_tpu_torch.fit_quantizer`` at full width (seeded
    random weights, bf16, batch 32) over phase 10's seeded corpus, 5,000
    centres and a residual codebook: its pooled features equal
    ``Segmenter.process``'s on the same arrays in the same batches, the
    seeding kernel's launches in the call counted from 0 (one a fit), the
    residual the features less their nearest centre."""
    from sylber_tpu_torch import Segmenter, fit_quantizer
    from sylber_tpu_torch.quantizer import KMQuantizer
    from sylber_tpu_torch.segment_corpus import segmenter_config
    from sylber_tpu_torch.utils.audio import load_for_inference

    corpus = tmp / "fit_quantizer"
    corpus.mkdir()
    write_corpus(corpus, CORPUS_UTTS, CORPUS_SECONDS)
    names = sorted(p.stem for p in corpus.glob("w*.wav"))
    (tmp / "manifest.txt").write_text("\n".join(names) + "\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, launches = counted_call(counters, lambda: fit_quantizer.main(
            ["--manifest", str(tmp / "manifest.txt"), "--wav-dir", str(corpus),
             "--n-clusters", "5000", "--out", str(tmp / "km5000.npy"), "--residual-out",
             str(tmp / "km5000_res.npy"), "--dtype", "bfloat16", "--precision", "default",
             "--batch-size", "32", "--device", "cuda"]))
    wall = time.perf_counter() - t0
    seeding = launches["kmeanspp"]
    seg = Segmenter(hubert_config=segmenter_config("bfloat16", "default"), device="cuda")
    wavs = [load_for_inference(corpus / f"{n}.wav") for n in names]
    direct = np.concatenate([o["segment_features"] for i in range(0, len(wavs), 32)
                             for o in seg.process(wavs[i: i + 32], in_second=False,
                                                  return_hidden=False)])
    equal = direct.shape == out["features"].shape and np.array_equal(direct, out["features"])
    c1, c2 = np.load(tmp / "km5000.npy"), np.load(tmp / "km5000_res.npy")
    nearest = KMQuantizer(c1, device="cuda").get_indices(out["features"]).cpu().numpy()
    res_err = float(np.abs(out["features"] - c1[nearest] - out["residual"]).max())
    ok = (equal and seeding == 2 and c1.shape == (5000, 768) and c2.shape == (5000, 768)
          and np.isfinite(c1).all() and np.isfinite(c2).all() and res_err <= 1e-4)
    rec = dict(utts=len(names), segments=out["segments"], pool_s=out["pool_seconds"],
               segments_per_s=out["segments_per_s"], fit_s=out["fit_seconds"],
               residual_fit_s=out["residual_fit_seconds"], wall_s=wall,
               features_equal_process=bool(equal), kmeanspp_launches=seeding,
               launches=launches, residual_err=res_err, ok=bool(ok))
    log(f"phase 13 fit_quantizer full width bf16, {len(names)} utterances: {rec['segments']} "
        f"segments at {rec['segments_per_s']:.0f} a second (pooling {rec['pool_s']:.2f} s), fit "
        f"5,000 centres {rec['fit_s']:.2f} s, residual fit {rec['residual_fit_s']:.2f} s; "
        f"features equal to process(): {equal}; launches in the call {launches}; residual err "
        f"{res_err:.3g} ok={rec['ok']}  [{smi}]")
    return rec


def production_seeding(torch, km, smi):
    """The seeding kernel at the production pool's shape (n 110,109, d 144)
    on seeded features of ``PRODUCTION_CLUSTERS`` clusters, at each k
    against its plain version (``kmeanspp_record``; the plain version timed
    at the first k)."""
    n, d, ks = PRODUCTION_SEEDING
    x = mixture(torch, n, d, seed=13, clusters=PRODUCTION_CLUSTERS)
    recs = []
    for k in ks:
        recs.append(kmeanspp_record(torch, km, "production", x, k, seed=k, time_plain=k == ks[0]))
        log_seeding("phase 13", recs[-1], smi)
    del x
    rec = dict(recs[0], timed=recs, ok=all(r["ok"] for r in recs))
    return rec


def gateloop_bf16_record(torch, gl, smi, shape=(8, 265, 512)):
    """The bf16 regressor's GateLoop call (bf16 thirds of one product cast
    to float32, the float32 kernel, the output cast back) against its plain
    version on the same bf16 inputs (bit for bit), timed beside its bound:
    the function's own bytes (three bf16 inputs read once, the bf16 output
    written once), and beside ``cast_bound_ms``, the float32 kernel's bytes
    plus its casts' (each bf16 input read and written as float32, the
    float32 output read and written as bf16)."""
    B, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, kv, g = torch.randn(B, L, 3 * D, device="cuda", generator=gen).bfloat16().chunk(3, -1)
    a = torch.sigmoid(g)
    run = lambda: gl.gate_loop_operator(q, kv, a)  # noqa: E731
    plain = lambda: gl.gate_loop_operator_plain(q, kv, a).to(q.dtype)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    n = B * L * D
    b_ms, b_by = bound_ms(8.0 * n, 3.0 * n, "float32")
    rec = dict(shape=[B, L, D], dtype="bfloat16", mismatches=bad, tol=0.0,
               max_abs_err=float((got.float() - want.float()).abs().max()),
               ok=bad == 0 and bool(torch.isfinite(got.float()).all()),
               ms=graph_time_ms(torch, run, 20), plain_ms=graph_time_ms(torch, plain, 2),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               cast_bound_ms=bound_ms((16.0 + 3 * 6.0 + 6.0) * n, 3.0 * n, "float32")[0])
    log(f"phase 13 gate_loop_operator bf16 {rec['shape']} (casts + the float32 kernel): "
        f"{bad} mismatches ok={rec['ok']}; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {rec['ms'] / b_ms:.1f}x; with the casts' bytes: "
        f"{rec['cast_bound_ms']:.4f})  [{smi}]")
    return rec


def vocoder_proof_resume(torch, counters, smi, tmp):
    """``python -m sylber_tpu_torch.vocoder_proof`` (the recipe's B16, over 64
    utterances rather than 256: the corpus is built on the host three times)
    for ``VOCODER_PROOF_STEPS`` steps, and again as two halves through
    ``--state-out`` / ``--resume-from``, cuDNN deterministic: the generator
    and the discriminators bit-equal; the step ms; the three calls'
    launches, each counted from 0."""
    from sylber_tpu_torch import vocoder_proof

    common = ["--batch-size", "16", "--n-utts", "64", "--save-every", "0", "--log-every",
              str(VOCODER_PROOF_STEPS), "--skip-gates", "--device", "cuda"]
    half = str(VOCODER_PROOF_STEPS // 2)
    launches = {}
    with deterministic_cudnn(torch), contextlib.redirect_stdout(io.StringIO()):
        whole, got = counted_call(counters, lambda: vocoder_proof.main(
            ["--steps", str(VOCODER_PROOF_STEPS), "--out-dir", str(tmp / "whole"), *common]))
        add_launches(launches, got)
        _, got = counted_call(counters, lambda: vocoder_proof.main(
            ["--steps", half, "--out-dir", str(tmp / "first"), "--state-out",
             str(tmp / "state.pt"), *common]))
        add_launches(launches, got)
        resumed, got = counted_call(counters, lambda: vocoder_proof.main(
            ["--steps", half, "--out-dir", str(tmp / "second"), "--resume-from",
             str(tmp / "state.pt"), *common]))
        add_launches(launches, got)
    a, b = whole["state"], resumed["state"]
    differ = [f"{name}.{k}" for name in ("generator", "mpd", "msd")
              for k, v in getattr(a, name).state_dict().items()
              if not torch.equal(v, getattr(b, name).state_dict()[k])]
    rec = dict(steps=VOCODER_PROOF_STEPS, resumed_at=int(half), bit_equal=not differ,
               differing=differ[:5], step_ms=resumed["timing"]["train_s"] / int(half) * 1e3,
               step_ms_whole=whole["timing"]["train_s"] / VOCODER_PROOF_STEPS * 1e3,
               state_bytes=(tmp / "state.pt").stat().st_size, eval=resumed["eval"],
               launches=launches, ok=not differ)
    log(f"phase 13 vocoder_proof B16, {VOCODER_PROOF_STEPS} steps against {half} + {half} "
        f"resumed (cuDNN deterministic): parameters bit-equal {rec['bit_equal']} "
        f"{rec['differing']}; step {rec['step_ms']:.2f} ms (the resumed half), "
        f"{rec['step_ms_whole']:.2f} ms over the whole run with its first steps; train state "
        f"{rec['state_bytes'] / 1e6:.0f} MB  [{smi}]")
    return rec


def demo_run(torch, counters, smi, tmp):
    """``python -m sylber_tpu_torch.demo --mini-fixtures`` at 4 ODE steps with
    ``--audio-out``: a finite waveform of the input's frames x 320; its
    launches counted from 0."""
    from sylber_tpu_torch import demo

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, launches = counted_call(counters, lambda: demo.main(
            ["--wav", str(FIXTURES / "speechlike.wav"), "--mini-fixtures", "--steps", "4",
             "--audio-out", "demo.wav", "--out-dir", str(tmp / "demo"), "--device", "cuda"]))
    w = out["waveform"]
    ok = (w is not None and len(w) == out["art"].shape[1] * 320 and bool(np.isfinite(w).all())
          and (tmp / "demo" / "demo.wav").exists())
    rec = dict(segments=len(out["segments"]), samples=0 if w is None else len(w),
               peak=float(np.abs(w).max()) if ok else None, wall_s=time.perf_counter() - t0,
               launches=launches, ok=bool(ok))
    log(f"phase 13 demo --mini-fixtures: {rec['segments']} segments, {rec['samples']} samples, "
        f"peak {rec['peak']}, {rec['wall_s']:.2f} s, launches {launches} ok={rec['ok']}  "
        f"[{smi}]")
    return rec


def eval_phase(torch, counters, smi):
    """Phase 13: the evaluation entry points (the token chain's
    ``eval_chain``, fit_quantizer, the vocoder proof, the demo), each call
    on the card with every counter set to 0 just before it and read just
    after, before its checks run (``launches``, their sum: the
    ``eval_launches`` of the kernels line; conv0, small attention and both
    segmentation passes must launch in each codebook's chain, the seeding
    kernel in fit_quantizer), then the seeding kernel at the production
    shape and the bf16 regressor's GateLoop call against its plain
    version."""
    import sylber_tpu_torch.ops.gateloop as gl
    from sylber_tpu_torch.flow import kmeans as km

    t0 = time.perf_counter()
    counters = counters + [km.kmeanspp]
    chain = token_chain_agreement(torch, counters, smi)
    chain_launches = {}
    for r in chain:
        add_launches(chain_launches, r["launches"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_evals_") as tmp:
        tmp = Path(tmp)
        fitq = fit_quantizer_run(torch, counters, smi, tmp)
        vocoder = vocoder_proof_resume(torch, counters, smi, tmp)
        demo = demo_run(torch, counters, smi, tmp)
    launches = dict(chain_launches)
    for r in (fitq, vocoder, demo):
        add_launches(launches, r["launches"])
    seeding = production_seeding(torch, km, smi)
    gateloop = gateloop_bf16_record(torch, gl, smi)
    rep = dict(token_chain=chain, chain_launches=chain_launches, fit_quantizer=fitq,
               vocoder_proof=vocoder, demo=demo, production_seeding=seeding,
               gateloop_bf16=gateloop, launches=launches, seconds=time.perf_counter() - t0)
    log(f"phase 13: launches in the token chain's eval_chain calls {chain_launches}; over the "
        f"phase's entry-point calls {launches}; took {rep['seconds']:.1f} s  [{smi}]")
    bad = ([f"km{r['codebook']}" + (f" (never launched {r['idle_kernels']})"
                                    if r["idle_kernels"] else "") for r in chain if not r["ok"]]
           + [name for name, r in (("fit_quantizer", fitq), ("vocoder resume", vocoder),
                                   ("demo", demo), ("kmeanspp production", seeding),
                                   ("gate_loop bf16", gateloop))
              if not r["ok"]])
    if bad:
        raise AssertionError(f"phase 13 failed: {bad}")
    return rep


# ---------------------------------------------------------------- phase 14

CEILING_TOL = 1e-6         # the encoder-segment ceiling, card vs CPU (the same segments)
DECODABILITY_TOL = 5e-3    # r, card (TF32: precision "default") vs CPU
VQ_PROBE_R_TOL = 2e-3      # the r of probes (a)-(e), card vs CPU
VQ_PROBE_MSE_RTOL = 0.05   # probe (f)'s MSE, card vs CPU: the VQ's argmin may flip
PARITY_SECONDS = 20.0      # the long parity utterance: 999 frames, the flash path
# STATUS.md:208-212 (the JAX package's runs): (pooled r, per-utterance r) on rich audio
RECORDED_DECODABILITY = {"mini_ckpt.json": (0.77, 0.28), "mini_ckpt_rich.json": (0.83, 0.14)}
WIDE_SEEDING = (("d4100", 512, 4100, 16), ("past_shared_memory", 64, 60000, 8))


def quiet(fn):
    """``fn`` with its standard output dropped (the entry points print their
    JSON)."""
    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()
    return run


def idle_kernels(launches, kernels=CHAIN_KERNELS):
    return [k for k in kernels if launches.get(k, 0) == 0]


def ceiling_agreement(counters, smi, tmp):
    """``pitch_modulation_ceiling_probe`` at its 48 utterances on the card
    (counted) and on the CPU."""
    from sylber_tpu_torch import pitch_modulation_ceiling_probe as ceiling

    t0 = time.perf_counter()
    card, launches = counted_call(counters, quiet(lambda: ceiling.main(
        ["--device", "cuda", "--out-dir", str(tmp / "ceiling_cuda")])))
    card_s = time.perf_counter() - t0
    cpu = quiet(lambda: ceiling.main(["--device", "cpu", "--out-dir", str(tmp / "ceiling_cpu")]))()
    same = len(card["segments"]) == len(cpu["segments"]) and all(
        np.array_equal(a, b) for a, b in zip(card["segments"], cpu["segments"]))
    gap = abs(card["oracle_segment_fill"] - cpu["oracle_segment_fill"])
    idle = idle_kernels(launches)
    ok = (same and card["oracle_truth_segments"] == cpu["oracle_truth_segments"]
          and gap <= CEILING_TOL and not idle)
    rec = dict(n_eval=card["n_eval_utts"], card=_without(card, "segments"),
               cpu=_without(cpu, "segments"), segments_equal=bool(same), fill_gap=gap,
               launches=launches, card_s=card_s, ok=bool(ok))
    log(f"phase 14 pitch_modulation_ceiling_probe ({rec['n_eval']} utterances): segments card "
        f"= CPU {same}; oracle_segment_fill card {card['oracle_segment_fill']:.6f} CPU "
        f"{cpu['oracle_segment_fill']:.6f} (gap {gap:.2g}, tol {CEILING_TOL}); "
        f"oracle_truth_segments {card['oracle_truth_segments']:.6f} / "
        f"{cpu['oracle_truth_segments']:.6f}; launches {launches}; card {card_s:.2f} s "
        f"ok={rec['ok']}  [{smi}]")
    return rec


def _without(d, key):
    return {k: v for k, v in d.items() if k != key}


def decodability_agreement(counters, smi, tmp):
    """``pitch_decodability_probe --style rich --n 56`` for both encoder
    fixtures on the card (counted) and on the CPU."""
    from sylber_tpu_torch import pitch_decodability_probe as dec

    rows = []
    for name, (pooled, per_utt) in RECORDED_DECODABILITY.items():
        argv = ["--encoder", str(FIXTURES / name), "--style", "rich", "--n", "56"]
        t0 = time.perf_counter()
        card, launches = counted_call(counters, quiet(lambda: dec.main(
            argv + ["--device", "cuda", "--out-dir", str(tmp / f"dec_cuda_{name}")])))
        card_s = time.perf_counter() - t0
        cpu = quiet(lambda: dec.main(argv + ["--device", "cpu",
                                             "--out-dir", str(tmp / f"dec_cpu_{name}")]))()
        gaps = {k: abs(card[k] - cpu[k]) for k in ("per_utt_mean_removed_pitch_r",
                                                   "pooled_pitch_r")}
        idle = idle_kernels(launches)
        rec = dict(encoder=name, card=card, cpu=cpu, gaps=gaps, launches=launches,
                   recorded_pooled_r=pooled, recorded_per_utt_r=per_utt, card_s=card_s,
                   ok=bool(max(gaps.values()) <= DECODABILITY_TOL and not idle))
        rows.append(rec)
        log(f"phase 14 pitch_decodability_probe {name} (rich, n 56): per-utterance r card "
            f"{card['per_utt_mean_removed_pitch_r']:.4f} CPU "
            f"{cpu['per_utt_mean_removed_pitch_r']:.4f}, pooled r card "
            f"{card['pooled_pitch_r']:.4f} CPU {cpu['pooled_pitch_r']:.4f} (gaps "
            f"{max(gaps.values()):.2g}, tol {DECODABILITY_TOL}); recorded pooled {pooled} / "
            f"per-utterance {per_utt} (not gated); launches {launches}; card {card_s:.2f} s "
            f"ok={rec['ok']}  [{smi}]")
    return rows


def vq_probe_agreement(counters, smi, tmp):
    """``vq_pitch_probe`` at its full size on the card (counted) and on the
    CPU, from the same initial state (a generator seeded 0)."""
    from sylber_tpu_torch import vq_pitch_probe as vqp

    t0 = time.perf_counter()
    card, launches = counted_call(counters, quiet(lambda: vqp.main(
        ["--device", "cuda", "--out-dir", str(tmp / "vq_cuda")])))
    card_s = time.perf_counter() - t0
    cpu = quiet(lambda: vqp.main(["--device", "cpu", "--out-dir", str(tmp / "vq_cpu")]))()
    r_gap = max(abs(card["probes"][p][k] - cpu["probes"][p][k])
                for p in card["probes"] for k in ("r_train", "r_heldout"))
    mse_gap = {s: abs(card["supervised_mse"][s] - cpu["supervised_mse"][s])
               / cpu["supervised_mse"][s] for s in (100, 600)}
    idle = idle_kernels(launches)
    ok = r_gap <= VQ_PROBE_R_TOL and max(mse_gap.values()) <= VQ_PROBE_MSE_RTOL and not idle
    rec = dict(card=card, cpu=cpu, r_gap=r_gap, mse_rel_gap=mse_gap, launches=launches,
               card_s=card_s, ok=bool(ok))
    probes = ", ".join(f"({p}) {card['probes'][p]['r_heldout']:.3f}/"
                       f"{cpu['probes'][p]['r_heldout']:.3f}" for p in card["probes"])
    log(f"phase 14 vq_pitch_probe (64 + 24 utterances, 600 steps of 4,096): held-out r card/CPU "
        f"{probes} (largest gap {r_gap:.2g}, tol {VQ_PROBE_R_TOL}); (f) MSE at 100 / 600 card "
        f"{card['supervised_mse'][100]:.4f} / {card['supervised_mse'][600]:.4f}, CPU "
        f"{cpu['supervised_mse'][100]:.4f} / {cpu['supervised_mse'][600]:.4f} (relative gaps "
        f"{mse_gap[100]:.3g} / {mse_gap[600]:.3g}, tol {VQ_PROBE_MSE_RTOL}); history only: "
        f"the old r4 tokenizer's pre-VQ r 0.884, quantized 0.000 (STATUS.md:130-139); "
        f"launches {launches}; card {card_s:.2f} s ok={rec['ok']}  [{smi}]")
    return rec


def parity_runs(torch, counters, smi, tmp):
    """``parity_vs_reference`` on random full-width HuBERT-base weights
    saved as an HF state dict (``torch.manual_seed(0)``), the port on the
    card (counted) against HF on the CPU, on ``speechlike.wav`` and on a
    20 s synthetic utterance (``data/synthetic.py``, 16-bit WAV)."""
    from scipy.io import wavfile

    from sylber_tpu_torch import parity_vs_reference as pvr
    from sylber_tpu_torch.data.synthetic import synth_utterance

    try:
        os.environ.setdefault("USE_TF", "0")
        from transformers import HubertConfig as HFConfig
        from transformers import HubertModel as HFModel
    except ImportError as e:
        raise AssertionError(f"phase 14: the parity check's reference side needs transformers, "
                             f"which does not import here ({e})") from e
    torch.manual_seed(0)
    ckpt = tmp / "hubert_base_random.pt"
    torch.save(HFModel(HFConfig(num_hidden_layers=9)).state_dict(), ckpt)
    wav, _ = synth_utterance(np.random.RandomState(20), int(PARITY_SECONDS * 16000))
    long_wav = tmp / "synthetic_20s.wav"
    wavfile.write(long_wav, 16000, np.round(wav / np.abs(wav).max() * 30000).astype(np.int16))
    rows = []
    for name, path, flash in (("speechlike", FIXTURES / "speechlike.wav", False),
                              ("synthetic_20s", long_wav, True)):
        out = tmp / f"parity_{name}"
        t0 = time.perf_counter()
        code, launches = counted_call(counters, quiet(lambda: pvr.main(
            ["--ckpt", str(ckpt), "--wav", str(path), "--device", "cuda",
             "--out-dir", str(out)])))
        rep = json.loads((out / "parity_vs_reference.json").read_text())
        attention = "flash_attention" if flash else "small_attention"
        idle = idle_kernels(launches, ("conv0_gn_gelu", attention, "segment_pass1",
                                       "segment_pass2"))
        rec = dict(name=name, exit_code=code, report=rep, launches=launches,
                   wall_s=time.perf_counter() - t0, ok=bool(code == 0 and rep["ok"] and not idle))
        rows.append(rec)
        verdict = "PARITY OK" if code == 0 else "PARITY MISMATCH"
        log(f"phase 14 parity_vs_reference {name} ({rep['frames']} frames, {rep['segments']} "
            f"segments) vs HF HubertModel on the CPU: {verdict}, segments exact "
            f"{rep['segments_exact']}, boundary F1 "
            f"{rep['boundary_f1_tol0']:.4f}, hidden states max |delta| "
            f"{rep['hidden_states_max_abs_delta']:.3g} (tol {rep['tol']}), segment features "
            f"{rep['segment_features_max_abs_delta']:.3g}; launches {launches}; "
            f"{rec['wall_s']:.2f} s ok={rec['ok']}  [{smi}]")
    return rows


def analyses_phase(torch, counters, smi):
    """Phase 14: the analyses' entry points (each call on the card with every
    counter set to 0 just before it and read just after; ``launches``,
    their sum, is the ``analysis_launches`` of the kernels line), then the
    seeding kernel at the widths it used to refuse."""
    from sylber_tpu_torch.flow import kmeans as km
    from sylber_tpu_torch.models.hubert import matmul_precision

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analyses_") as tmp:
        tmp = Path(tmp)
        ceiling = ceiling_agreement(counters, smi, tmp)
        decodability = decodability_agreement(counters, smi, tmp)
        vq = vq_probe_agreement(counters, smi, tmp)
        parity = parity_runs(torch, counters, smi, tmp)
    launches = {}
    for r in [ceiling, vq] + decodability + parity:
        add_launches(launches, r["launches"])
    with matmul_precision("highest"):
        seeding = []
        for name, n, d, k in WIDE_SEEDING:
            seeding.append(kmeanspp_record(torch, km, name, mixture(torch, n, d, seed=n + d), k,
                                           seed=k))
            log_seeding("phase 14", seeding[-1], smi)
    rep = dict(ceiling=ceiling, decodability=decodability, vq_pitch_probe=vq, parity=parity,
               wide_seeding=seeding, launches=launches, seconds=time.perf_counter() - t0)
    log(f"phase 14: launches over the analyses' entry-point calls {launches}; took "
        f"{rep['seconds']:.1f} s  [{smi}]")
    bad = ([n for n, r in (("pitch_modulation_ceiling_probe", ceiling),
                           ("vq_pitch_probe", vq)) if not r["ok"]]
           + [f"pitch_decodability_probe {r['encoder']}" for r in decodability if not r["ok"]]
           + [f"parity_vs_reference {r['name']}" for r in parity if not r["ok"]]
           + [f"kmeanspp {r['name']}" for r in seeding if not r["ok"]])
    if bad:
        raise AssertionError(f"phase 14 failed: {bad}")
    return rep


def zstd_rate(store_dir):
    """The zstd decoder's MB/s of decompressed output on the host over every
    zarr chunk of the Orbax store ``store_dir`` (file reads apart), and the
    seconds of ``read_tree`` over the whole directory."""
    from sylber_tpu_torch.io.ocdbt import OcdbtStore
    from sylber_tpu_torch.io.orbax import read_tree
    from sylber_tpu_torch.io.zstd import decompress

    store = OcdbtStore(store_dir)
    frames = [store.read(k) for k in store.list() if not k.endswith(".zarray")]
    decompress(frames[0])  # the library built and loaded
    t0 = time.perf_counter()
    out = sum(len(decompress(f)) for f in frames)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_tree(store_dir)
    return dict(chunks=len(frames), compressed_bytes=sum(map(len, frames)), bytes=out,
                seconds=dt, mb_per_s=out / 1e6 / dt, read_tree_s=time.perf_counter() - t0)


def orbax_segmenter(torch, counters, Segmenter, HubertConfig):
    """The mini Segmenter from the Orbax copy of ``mini_ckpt.npz`` against
    the same model from the ``.npz``, both on the card, fp32 "highest", on 8
    utterances of 5 s: segments, features and hidden states bit-equal (the
    same weight bits). Launches of the Orbax model's call, counted from 0."""
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    kw = dict(hubert_config=HubertConfig(num_hidden_layers=meta["encoding_layer"],
                                         precision="highest", **hub),
              norm_threshold=meta["norm_threshold"], merge_threshold=meta["merge_threshold"],
              device="cuda")
    rng = np.random.RandomState(15)
    wavs = [speechlike(rng, 5 * 16000) for _ in range(8)]
    orbax = Segmenter(model_ckpt=str(FIXTURES / "orbax" / "mini_ckpt_params"), **kw)
    npz = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), **kw)
    got, launches = counted_call(counters, lambda: orbax.process(wavs, in_second=False))
    want = npz.process(wavs, in_second=False)
    diffs = [key for g, w in zip(got, want) for key in ("segments", "segment_features",
                                                        "hidden_states")
             if not np.array_equal(g[key], w[key])]
    nseg = [len(g["segments"]) for g in got]
    rec = dict(utterances=len(wavs), seconds=5.0, segments=nseg, bit_equal=not diffs,
               differing=sorted(set(diffs)), launches=launches,
               ok=not diffs and min(nseg) > 0 and all(launches[c.__name__] > 0 for c in (
                   counters[0], counters[1], counters[3], counters[4])))
    log(f"phase 15: Segmenter from the Orbax fixture vs mini_ckpt.npz on the card, 8 x 5 s: "
        f"segments, features and hidden states bit-equal {not diffs} {nseg}; launches "
        f"{launches} ok={rec['ok']}")
    return rec


def orbax_synthesis(torch, counters):
    """``SegmentSynthesis`` on the Orbax fixtures (``mini_ckpt_params`` as the
    encoder, ``mini_synth_params``) against the same model from the ``.npz``
    files, on the card: one fixed-grid resynthesis (midpoint, 8 steps) of 2
    utterances, art and segments bit-equal."""
    from sylber_tpu_torch.io.orbax import load_params
    from sylber_tpu_torch.synthesis import SegmentSynthesis

    npz, _ = _mini_synth(torch, "mini_synth", "cuda")
    params = {"hubert": load_params(FIXTURES / "orbax" / "mini_ckpt_params"),
              **load_params(FIXTURES / "orbax" / "mini_synth_params")}
    orbax = SegmentSynthesis(config=npz.config, params=params,
                             device="cuda")
    rng = np.random.RandomState(16)
    wav = np.stack([speechlike(rng, 3 * 16000) for _ in range(2)])
    (art, segs), launches = counted_call(counters, lambda: orbax.resynthesize(
        input_values=wav, steps=8, method="midpoint"))
    want_art, want_segs = npz.resynthesize(input_values=wav, steps=8, method="midpoint")
    same = bool(np.array_equal(art, want_art)
                and all(np.array_equal(a, b) for a, b in zip(segs, want_segs)))
    rec = dict(utterances=2, seconds=3.0, art_shape=list(art.shape), bit_equal=same,
               finite=bool(np.isfinite(art).all()), launches=launches,
               ok=same and bool(np.isfinite(art).all()) and all(
                   launches[c.__name__] > 0 for c in (counters[0], counters[1], counters[3],
                                                      counters[4])))
    log(f"phase 15: SegmentSynthesis from the Orbax fixtures vs the .npz on the card, 2 x 3 s "
        f"midpoint 8 steps: art {list(art.shape)} and segments bit-equal {same}; launches "
        f"{launches} ok={rec['ok']}")
    return rec


def orbax_resume(torch, counters, tmp):
    """The port's trainer resumed on the card from the JAX trainer's step 2
    (``tests/fixtures/orbax/tiny_train_ckpts``): the restored parameters,
    EMA, AdamW moments and step counts bit-equal to the fixture's arrays,
    then ``train()`` from there to step 5 (3 steps), every loss finite."""
    import shutil

    import yaml

    from sylber_tpu_torch.io.checkpoint import TrainCheckpointManager, state_dict_from_jax_params
    from sylber_tpu_torch.io.orbax import read_tree
    from sylber_tpu_torch.train.distill import init_train_state
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train

    recipe = yaml.safe_load((FIXTURES / "orbax" / "tiny_train.yaml").read_text())
    shutil.copytree(FIXTURES / "orbax" / "tiny_train_ckpts", tmp / "ckpts")
    tree = read_tree(tmp / "ckpts" / "2" / "default")
    state = init_train_state(distill_config_from_dict(dict(recipe["model"])), "cuda",
                             thresholder_kwargs=recipe["model"]["thresholder_configs"])
    names = [n for n, _ in state.student.named_parameters()]
    state.load_state_dict(TrainCheckpointManager(str(tmp / "ckpts")).restore(param_names=names))
    adam = tree["opt_state"][1][0]
    want = {"params": state_dict_from_jax_params(tree["params"]),
            "ema": state_dict_from_jax_params(tree["ema_params"]),
            "exp_avg": state_dict_from_jax_params(adam["mu"]),
            "exp_avg_sq": state_dict_from_jax_params(adam["nu"])}
    opt = {n: state.optimizer.state[p] for n, p in state.student.named_parameters()}
    got = {"params": state.student.state_dict(), "ema": state.teacher.state_dict(),
           "exp_avg": {n: opt[n]["exp_avg"] for n in names},
           "exp_avg_sq": {n: opt[n]["exp_avg_sq"] for n in names}}
    bad = [f"{what}/{k}" for what in want for k in want[what]
           if not torch.equal(got[what][k].cpu(), want[what][k])]
    counts = {float(opt[n]["step"]) for n in names}
    on_card = all(t.is_cuda for t in list(got["params"].values()) + [opt[n]["step"]
                                                                      for n in names])
    (_, launches) = counted_call(counters, lambda: train(
        recipe, out_dir=str(tmp), max_steps=5, log_every=1, ckpt_every=0, device="cuda"))
    rows = [json.loads(ln) for ln in open(tmp / "metrics.jsonl")]
    losses = [r["loss"] for r in rows]
    rec = dict(restored_step=state.step, bit_equal=not bad, differing=bad[:8],
               adam_counts=sorted(counts), on_card=on_card,
               steps=[r["step"] for r in rows], losses=losses, launches=launches,
               ok=(not bad and counts == {float(adam["count"])} and state.step == 2 and on_card
                   and [r["step"] for r in rows] == [3, 4, 5]
                   and all(np.isfinite(x) for x in losses)
                   and all(launches[c.__name__] > 0 for c in (counters[0], counters[1],
                                                               counters[3], counters[4]))))
    log(f"phase 15: the port's trainer resumed on the card from the JAX trainer's step 2: "
        f"parameters, EMA and AdamW moments bit-equal {not bad} ({len(names)} leaves each, "
        f"step counts {sorted(counts)}), steps {rec['steps']} losses "
        f"{[f'{x:.6g}' for x in losses]}; launches {launches} ok={rec['ok']}")
    return rec


def orbax_phase(torch, counters, Segmenter, HubertConfig, smi):
    """Phase 15: the JAX trainer's Orbax checkpoints read by the port, with no
    JAX (``io/zstd.py``, ``io/ocdbt.py``, ``io/orbax.py``): the host decoder's
    rate, then the Segmenter, the resynthesis chain and a resumed trainer on
    the committed fixtures on the card. ``launches``, the sum of the card
    calls' (each counted from 0), is the ``orbax_launches`` of the kernels
    line."""
    from sylber_tpu_torch.models.hubert import matmul_precision

    t0 = time.perf_counter()
    rate = zstd_rate(FIXTURES / "orbax" / "mini_ckpt_params" / "params")
    log(f"phase 15: zstd decoder {rate['mb_per_s']:.1f} MB/s of decompressed output on the "
        f"host ({rate['chunks']} zarr chunks, {rate['compressed_bytes']} -> {rate['bytes']} "
        f"bytes in {rate['seconds']:.4f} s); read_tree of mini_ckpt_params "
        f"{rate['read_tree_s']:.3f} s  [{smi}]")
    segmenter = orbax_segmenter(torch, counters, Segmenter, HubertConfig)
    with matmul_precision("highest"):
        synthesis = orbax_synthesis(torch, counters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as tmp:
        resume = orbax_resume(torch, counters, Path(tmp))
    launches = {}
    for r in (segmenter, synthesis, resume):
        add_launches(launches, r["launches"])
    rep = dict(zstd=rate, segmenter=segmenter, synthesis=synthesis, resume=resume,
               launches=launches, seconds=time.perf_counter() - t0)
    log(f"phase 15: launches over the Orbax runs {launches}; took {rep['seconds']:.1f} s  "
        f"[{smi}]")
    bad = [n for n, r in (("segmenter", segmenter), ("synthesis", synthesis),
                          ("resume", resume)) if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 15 failed: {bad}")
    return rep


# ---------------------------------------------------------------- phase 16

def saves_on_the_critical_path(rows, saves):
    """Each save's cost on the critical path: the wall of the step after the
    save (the save runs after its step's metrics row, so its cost lands in
    the next row's time) minus the p50 of the walls of the steps after no
    save. ``rows``: the train rows, one a step; ``saves``: the manager's
    records. The last save's cost is its ``save_call_ms`` (no step follows)."""
    t = {r["step"]: r["time"] for r in rows}
    wall = {s: 1e3 * (t[s] - t[s - 1]) for s in t if s - 1 in t}
    saved = {r["step"] for r in saves}
    others = [ms for s, ms in wall.items() if s - 1 not in saved]
    p50 = float(np.median(others))
    out = []
    for r in saves:
        after = wall.get(r["step"] + 1)
        out.append(dict(r, step_wall_ms=after, other_steps_p50_ms=p50,
                        critical_path_ms=(after - p50) if after is not None else None))
    return out, others


def orbax_write_phase(torch, counters, Segmenter, HubertConfig, smi):
    """Phase 16: the port's trainer writes the JAX trainer's Orbax steps
    asynchronously (``io/checkpoint.py::TrainCheckpointManager``), at full
    width; the read-back, a resume and the ``Segmenter`` on the written
    ``params_final/``. ``launches``, the sum of its card calls' (each
    counted from 0), is the ``orbax_write_launches`` of the kernels line."""
    import shutil

    from sylber_tpu_torch.io.checkpoint import train_state_to_jax
    from sylber_tpu_torch.io.orbax import read_tree
    from sylber_tpu_torch.train.loop import distill_config_from_dict, train

    t0 = time.perf_counter()
    recipe = stage2_recipe("bfloat16", "default", 32)
    dcfg = distill_config_from_dict(dict(recipe["model"], accumulate_grad_batches=1))
    kw = dict(log_every=1, ckpt_every=2, device="cuda", max_to_keep=2)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the resume compared bit for bit beside
    launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_write_") as tmp:
            tmp = Path(tmp)
            run = tmp / "run"
            parts = {}
            t = time.perf_counter()
            state, got = counted_call(counters, lambda: train(recipe, out_dir=str(run),
                                                              max_steps=8, **kw))
            torch.cuda.synchronize()
            parts["train_8_steps_s"] = time.perf_counter() - t
            add_launches(launches, got)
            rows = [json.loads(ln) for ln in open(run / "metrics.jsonl")]
            rows = [r for r in rows if r["prefix"] == "train"]
            records = [json.loads(ln) for ln in open(run / "checkpoints.jsonl")]
            saves, others = saves_on_the_critical_path(rows, records)
            kept = sorted(int(d.name) for d in (run / "ckpts").iterdir() if d.name.isdigit())
            disk = {s: sum(f.stat().st_size for f in (run / "ckpts" / str(s)).rglob("*")
                           if f.is_file()) for s in kept}
            for r in saves:
                cp = ("none: no step follows" if r["critical_path_ms"] is None else
                      f"{r['critical_path_ms']:.1f} ms (step wall {r['step_wall_ms']:.1f} ms - "
                      f"p50 {r['other_steps_p50_ms']:.1f} ms of the steps after no save)")
                log(f"phase 16: save at step {r['step']}: critical path {cp}, save() call "
                    f"{r['save_call_ms']:.1f} ms (pinned buffer made {r['pin_ms']:.1f} ms), host "
                    f"copy {r['host_copy_ms']:.1f} ms, background write {r['write_s']:.3f} s "
                    f"at {r['mb_per_s']:.0f} MB/s, {r['bytes']} bytes of {r['leaves']} "
                    f"leaves, {r['disk_bytes']} in the data file  [{smi}]")
            log(f"phase 16: steps kept {kept}, bytes on disk {disk}; step walls "
                f"{[round(1e3 * (b['time'] - a['time']), 1) for a, b in zip(rows, rows[1:])]}"
                f" ms  [{smi}]")

            # the last step read back through the port's reader, against the live state
            t = time.perf_counter()
            names = [n for n, _ in state.student.named_parameters()]
            live = train_state_to_jax(state.state_dict(), names, dcfg)
            back = read_tree(run / "ckpts" / "8" / "default")
            bad, count = [], [0]

            def walk(a, b, path):
                if isinstance(a, dict):
                    if not isinstance(b, dict) or a.keys() != b.keys():
                        bad.append(path)
                        return
                    for k in a:
                        walk(a[k], b[k], f"{path}/{k}")
                elif isinstance(a, (list, tuple)):
                    if not isinstance(b, list) or len(a) != len(b):
                        bad.append(path)
                        return
                    for i, (x, y) in enumerate(zip(a, b)):
                        walk(x, y, f"{path}/{i}")
                elif a is None:
                    if b is not None:
                        bad.append(path)
                else:
                    count[0] += 1
                    x = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                         else np.asarray(a))
                    if x.dtype != b.dtype or x.shape != b.shape or not np.array_equal(
                            x.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)):
                        bad.append(path)

            walk(live, back, "state")
            parts["read_back_s"] = time.perf_counter() - t
            log(f"phase 16: step 8 read back by io/orbax.py: {count[0]} leaves, bit-equal to "
                f"the live state {not bad} {bad[:4]}")

            # a resume from step 6 for 2 steps against the uninterrupted run
            t = time.perf_counter()
            resumed = tmp / "resumed"
            shutil.copytree(run / "ckpts" / "6", resumed / "ckpts" / "6")
            again, got = counted_call(counters, lambda: train(
                recipe, out_dir=str(resumed), max_steps=8, **dict(kw, ckpt_every=0)))
            torch.cuda.synchronize()
            add_launches(launches, got)
            rows_b = [json.loads(ln) for ln in open(resumed / "metrics.jsonl")]
            la, lb = rows[-1]["loss"], rows_b[-1]["loss"]
            rel = abs(la - lb) / abs(la)
            pa, pb = state.student.state_dict(), again.student.state_dict()
            err = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
            bits = all(torch.equal(pa[k], pb[k]) for k in pa)
            resume = dict(loss_step8=la, loss_step8_resumed=lb, loss_rel_err=rel,
                          param_max_abs_err=err, bit_equal=bits,
                          steps_logged=[r["step"] for r in rows_b],
                          ok=bool(rel <= 1e-6 and err <= 1e-6
                                  and [r["step"] for r in rows_b] == [7, 8]))
            log(f"phase 16: resumed from the Orbax step 6 for 2 steps: step 8 loss {la:.7g} "
                f"uninterrupted vs {lb:.7g} (rel {rel:.2g}, tol 1e-6), parameters max |diff| "
                f"{err:.3g} (tol 1e-6), bit-equal {bits} ok={resume['ok']}")
            del state, again
            torch.cuda.empty_cache()
            parts["resume_s"] = time.perf_counter() - t
            t = time.perf_counter()

            # the Segmenter from the written params_final/ against the .npz
            seg_kw = dict(hubert_config=HubertConfig(num_hidden_layers=9), norm_threshold=0.0,
                          merge_threshold=0.9, device="cuda")
            rng = np.random.RandomState(16)
            wavs = [speechlike(rng, 5 * 16000) for _ in range(4)]
            orbax = Segmenter(model_ckpt=str(run / "params_final"), **seg_kw)
            npz = Segmenter(model_ckpt=str(run / "params_final.npz"), **seg_kw)
            out, got = counted_call(counters, lambda: orbax.process(wavs, in_second=False))
            add_launches(launches, got)
            want = npz.process(wavs, in_second=False)
            diffs = sorted({key for g, w in zip(out, want)
                            for key in ("segments", "segment_features", "hidden_states")
                            if not np.array_equal(g[key], w[key])})
            nseg = [len(g["segments"]) for g in out]
            parts["segmenters_s"] = time.perf_counter() - t
            segmenter = dict(utterances=4, seconds=5.0, segments=nseg, bit_equal=not diffs,
                             differing=diffs, launches=got,
                             ok=not diffs and min(nseg) > 0)
            log(f"phase 16: Segmenter from the written params_final/ vs params_final.npz, 4 x "
                f"5 s: segments, features and hidden states bit-equal {not diffs} {nseg}; "
                f"launches {got}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    idle = [c.__name__ for c in (counters[0], counters[1], counters[3], counters[4])
            if launches.get(c.__name__, 0) == 0]
    rep = dict(recipe="stage2_recipe('bfloat16', 'default', 32)", steps=8, ckpt_every=2,
               max_to_keep=2, saves=saves, other_steps_ms=others, kept=kept,
               disk_bytes=disk, read_back=dict(leaves=count[0], bit_equal=not bad,
                                               differing=bad[:8]),
               resume=resume, segmenter=segmenter, launches=launches, parts_s=parts,
               seconds=time.perf_counter() - t0)
    log(f"phase 16: launches over the trainer's and the Segmenter's calls {launches}; took "
        f"{rep['seconds']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in parts.items())})  "
        f"[{smi}]")
    failed = [n for n, ok in (("read_back", not bad), ("resume", resume["ok"]),
                              ("segmenter", segmenter["ok"]), ("launches", not idle),
                              ("steps kept", kept == [6, 8])) if not ok]
    if failed:
        raise AssertionError(f"phase 16 failed: {failed} (kernels never launched: {idle})")
    return rep


# ---------------------------------------------------------------- the reproductions

def table_gaps(got, want):
    """Each row's numbers both tables hold (a vocoder leg's as
    ``vocoder.<key>``): ``{row: {metric: (got, recorded)}}``."""
    rows = {}
    for row, m in want.items():
        g = got.get(row)
        if g is None:
            continue
        flat = {}
        for k, v in m.items():
            if isinstance(v, dict):
                flat.update({f"{k}.{kk}": (g.get(k, {}).get(kk), vv) for kk, vv in v.items()})
            else:
                flat[k] = (g.get(k), v)
        rows[row] = {k: (a, b) for k, (a, b) in flat.items()
                     if isinstance(a, (int, float)) and isinstance(b, (int, float))}
    return rows


def prediction_misses(gaps):
    """The recorded-codebook prediction (correlations within
    ``PREDICTED_CORR_GAP``, L1s within ``PREDICTED_L1_REL_GAP`` of the
    recorded) against a table's gaps: the metrics that miss it."""
    miss = []
    for row, m in gaps.items():
        for k, (a, b) in m.items():
            if "corr" in k or k.endswith("mod_r"):
                if abs(a - b) > PREDICTED_CORR_GAP:
                    miss.append(f"{row} {k} {a:.4f} vs {b:.4f}")
            elif "l1" in k and abs(a - b) > PREDICTED_L1_REL_GAP * abs(b):
                miss.append(f"{row} {k} {a:.4f} vs {b:.4f}")
    return miss


def reproduce_tokens(torch, smi, out_dir="runs/reproduce_tokens"):
    """The token-chain tables on the card beside the recorded ones: v1 and
    rich on the recorded codebooks and refit, the pitch chain, the
    production codebooks; each with the JAX package's gates (the script
    fails after all ran when one missed)."""
    from sylber_tpu_torch import pitch_chain_proof, production_codebooks, token_chain_proof

    runs = [("token_chain_v1_recorded", token_chain_proof, ["--codebooks", "recorded"],
             "token_chain.json"),
            ("token_chain_v1_refit", token_chain_proof, [], "token_chain.json"),
            ("token_chain_rich_recorded", token_chain_proof,
             ["--style", "rich", "--codebooks", "recorded"], "token_chain_rich.json"),
            ("token_chain_rich_refit", token_chain_proof, ["--style", "rich"],
             "token_chain_rich.json"),
            ("pitch_chain", pitch_chain_proof, [], "token_chain_rich_pitch.json"),
            ("production_codebooks", production_codebooks, [], "token_chain_prod.json")]
    results, missed = [], {}
    for label, module, argv, recorded in runs:
        t0 = time.perf_counter()
        out = module.main([*argv, "--out-dir", f"{out_dir}/{label}", "--skip-gates",
                           "--device", "cuda"])
        wall = time.perf_counter() - t0
        gaps = table_gaps(out["table"], json.loads((FIXTURES / recorded).read_text())["table"])
        for row, m in gaps.items():
            log(f"reproduce-tokens {label} {row}: " + ", ".join(
                f"{k} {a:.4g} (recorded {b:.4g}, {a - b:+.4g})" for k, (a, b) in m.items()))
        rec = dict(label=label, wall_s=wall, gates_missed=out["gates_missed"],
                   seconds=out.get("seconds"), table=out["table"],
                   gaps={r: {k: a - b for k, (a, b) in m.items()} for r, m in gaps.items()})
        if label.endswith("_recorded"):
            rec["prediction_misses"] = prediction_misses(gaps)
            log(f"reproduce-tokens {label}: the prediction (correlations within "
                f"{PREDICTED_CORR_GAP}, L1s within {PREDICTED_L1_REL_GAP:.0%}) missed by "
                f"{len(rec['prediction_misses'])}: {rec['prediction_misses']}")
        log(f"reproduce-tokens {label}: {wall:.1f} s on the card, gates missed "
            f"{out['gates_missed']}  [{smi}]")
        if out["gates_missed"]:
            missed[label] = out["gates_missed"]
        results.append(rec)
    log(json.dumps(dict(reproduce_tokens=results, card=smi), default=str))
    if missed:
        raise AssertionError(f"the reproduced tables miss the JAX package's gates: {missed}")
    return results


VOCODER_TRACE_ROWS = (  # (recorded table, style, codebook size, held-out utterances)
    ("token_chain.json", "v1", 64, 24), ("token_chain_rich.json", "rich", 1024, 48),
    ("token_chain_rich.json", "rich", 4096, 48), ("token_chain_rich_pitch.json", "pitch", 1024, 24))
VOCODER_TRACE_DRAWS = 4  # the noise channel's draws: seeds 0 (the port's own) to 3


def trace_vocoder_leg(torch, smi):
    """The recorded-codebook rows whose vocoder f0_corr sits 0.020-0.026
    from the recorded table (``VOCODER_TRACE_ROWS``), on the card at the
    recipe (the held-out set, 50 ODE steps). The chain's art twice: with the
    regressor as configured (TF32 on the card: the reproduction's) and at
    "highest". Its vocoder leg: the reproduction's (noise draw of seed 0,
    the generator's convs in TF32), the same at "highest", the draws of
    seeds 1 to ``VOCODER_TRACE_DRAWS`` - 1, and the "highest" art's. Which
    of the noise channel, the vocoder's TF32 and the art's own rounding
    moves f0_corr by the gap."""
    import dataclasses

    from sylber_tpu_torch import pitch_chain_proof as pcp
    from sylber_tpu_torch import token_chain_proof as tcp
    from sylber_tpu_torch.quantizer import KMQuantizer
    from sylber_tpu_torch.train.synthesis_loop import build_synthesis_corpus, eval_chain

    rows = []
    for table, style, K, n_eval in VOCODER_TRACE_ROWS:
        t0 = time.perf_counter()
        rich = style != "v1"
        heldout = build_synthesis_corpus(n_eval, 5.0, seed=tcp.HELDOUT_SEED,
                                         style="rich" if rich else "v1")
        cents = np.load(FIXTURES / f"mini_codebook{'_rich' if rich else ''}_{K}.npy")
        if style == "pitch":
            synth, nt, mt = pcp.build_pitch_synth(device="cuda")
        else:
            synth, nt, mt = tcp.build_synth(style=style, device="cuda")
        synth.quantizer = KMQuantizer(cents.astype(np.float32), device="cuda")
        art, m = eval_chain(synth, nt, mt, heldout, steps=50)
        synth.config = dataclasses.replace(synth.config, regressor=dataclasses.replace(
            synth.config.regressor, precision="highest"))
        art_h, m_h = eval_chain(synth, nt, mt, heldout, steps=50)
        dec, meta = vocoder = tcp.load_vocoder("mini_vocoder_rich" if rich else "mini_vocoder",
                                               "cuda")
        shape = (len(art), art.shape[1] * 320)

        def leg(a, seed=0, precision="default"):
            noise = None if seed == 0 else torch.randn(
                shape, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
            dec.precision = precision
            try:
                return tcp.vocoder_leg(a, heldout, vocoder=vocoder, noise=noise)["f0_corr"]
            finally:
                dec.precision = "default"

        draws = [leg(art, seed) for seed in range(VOCODER_TRACE_DRAWS)]
        recorded = json.loads((FIXTURES / table).read_text())["table"][f"km{K}"]
        rec = dict(table=table, style=style, codebook=K, n_eval=n_eval,
                   recorded=recorded["vocoder"]["f0_corr"], reproduced=draws[0],
                   vocoder_highest=leg(art, 0, "highest"), draws=draws,
                   art_highest=leg(art_h), art_rel_diff=rel_err(art, art_h),
                   pitch_corr=dict(recorded=recorded["pitch_corr"], reproduced=m["pitch_corr"],
                                   art_highest=m_h["pitch_corr"]),
                   seconds=time.perf_counter() - t0)
        rows.append(rec)
        r = rec["recorded"]
        log(f"trace-vocoder-leg {style} km{K} ({n_eval} utts, 50 steps): f0_corr recorded "
            f"{r:.4f}, reproduced {rec['reproduced']:.4f} ({rec['reproduced'] - r:+.4f}); "
            f"the vocoder at highest {rec['vocoder_highest']:.4f} "
            f"({rec['vocoder_highest'] - rec['reproduced']:+.4f}); noise draws "
            f"{[round(d, 4) for d in draws]}; the art at highest {rec['art_highest']:.4f} "
            f"({rec['art_highest'] - rec['reproduced']:+.4f}; the art moved "
            f"{rec['art_rel_diff']:.3g} of its largest, pitch_corr {m['pitch_corr']:.4f} -> "
            f"{m_h['pitch_corr']:.4f}, recorded {recorded['pitch_corr']:.4f}); "
            f"{rec['seconds']:.1f} s  [{smi}]")
    log(json.dumps(dict(trace_vocoder_leg=rows, card=smi)))
    return rows


def reproduce_vocoder(torch, smi, out_dir="runs/reproduce_vocoder", styles=("v1", "rich")):
    """``mini_vocoder.json``'s recipe (8,000 steps, B16, 256 utterances) and
    the rich one on the card: 50 steps timed first and the projected wall
    printed, then the run, its eval beside the recorded one with the gates
    (the script fails after both ran when one missed)."""
    from sylber_tpu_torch import vocoder_proof

    results, missed = [], {}
    for style in styles:
        prefix = "mini_vocoder" + ("_rich" if style == "rich" else "")
        meta = json.loads((FIXTURES / f"{prefix}.json").read_text())
        rec_train = meta["train"]
        common = ["--batch-size", str(rec_train["batch_size"]), "--n-utts",
                  str(rec_train["n_utts"]), "--style", style, "--fixture-prefix", prefix]
        probe = vocoder_proof.main(["--steps", "50", "--save-every", "0", "--log-every", "50",
                                    "--skip-gates", "--out-dir", f"{out_dir}/probe_{style}",
                                    "--device", "cuda", *common])
        step_ms = probe["timing"]["train_s"] / 50 * 1e3
        log(f"reproduce-vocoder {style}: 50 steps at {step_ms:.2f} ms a step; {rec_train['steps']} "
            f"steps projected at {rec_train['steps'] * step_ms / 1e3:.0f} s  [{smi}]")
        t0 = time.perf_counter()
        out = vocoder_proof.main(["--steps", str(rec_train["steps"]), "--save-every", "2000",
                                  "--log-every", "500", "--skip-gates", "--out-dir",
                                  f"{out_dir}/{style}", "--state-out",
                                  f"{out_dir}/{style}/state.pt", "--device", "cuda", *common])
        wall = time.perf_counter() - t0
        ev, want = out["eval"], meta["eval"]
        log(f"reproduce-vocoder {style}: {rec_train['steps']} steps in {wall:.1f} s ("
            f"{out['timing']['train_s'] / rec_train['steps'] * 1e3:.2f} ms a step); eval "
            + ", ".join(f"{k} {ev[k]:.4f} (recorded {want[k]:.4f})" for k in want)
            + f"; random init mel_l1 {out['eval_random_init']['mel_l1']:.4f} (recorded "
            f"{meta['eval_random_init']['mel_l1']:.4f}); gates missed {out['gates_missed']}"
            f"  [{smi}]")
        if out["gates_missed"]:
            missed[style] = out["gates_missed"]
        results.append(dict(style=style, probe_step_ms=step_ms, wall_s=wall,
                            step_ms=out["timing"]["train_s"] / rec_train["steps"] * 1e3,
                            eval=ev, eval_random_init=out["eval_random_init"], recorded=want,
                            gates_missed=out["gates_missed"]))
    log(json.dumps(dict(reproduce_vocoder=results, card=smi)))
    if missed:
        raise AssertionError(f"the reproduced vocoders miss the JAX package's gates: {missed}")
    return results


def reproduce_vq(torch, smi, out_dir="runs/reproduce_vq"):
    """``train_synthesis --tokens`` on ``configs/sylber_resynthesis_tokens_mini.yaml``
    (12,000 steps, B32) on the card, 50 steps timed first and the projected
    wall printed; its 50-step eval beside ``mini_vq_synth.json``'s with the
    JAX package's gates (``tests/parity/test_token_resynthesis.py:264-266``:
    loud_corr > 0.6, and pitch_corr > 0.5 with the pitch head)."""
    import yaml

    from sylber_tpu_torch.train.vq_synthesis import eval_gate_failures, train_vq_synthesis

    cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis_tokens_mini.yaml").read_text())
    cfg["speech_model_ckpt"] = str(FIXTURES / "mini_ckpt.npz")
    recorded = json.loads((FIXTURES / "mini_vq_synth.json").read_text())["eval"]
    steps = int(cfg["train"]["max_steps"])
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        train_vq_synthesis(cfg, out_dir=f"{out_dir}/probe", max_steps=50, log_every=50,
                           eval_steps=2, device="cuda")
        probe_s = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in open(Path(out_dir) / "probe" / "metrics.jsonl")]
    sps = [r["steps_per_sec"] for r in rows if r.get("prefix") == "train"][-1]
    log(f"reproduce-vq: 50 steps at {1e3 / sps:.2f} ms a step (the probe's call {probe_s:.1f} "
        f"s); {steps} steps projected at {steps / sps:.0f} s  [{smi}]")
    t0 = time.perf_counter()
    _, _, ev = train_vq_synthesis(cfg, out_dir=f"{out_dir}/run", log_every=500, eval_steps=50,
                                  device="cuda")
    wall = time.perf_counter() - t0
    missed = eval_gate_failures(ev, float(cfg["train"].get("pitch_loss_weight", 0.0)) > 0)
    ok = not missed
    log(f"reproduce-vq: {steps} steps and the eval in {wall:.1f} s; "
        + ", ".join(f"{k} {ev[k]:.4f} (recorded {recorded[k]:.4f})" for k in recorded
                    if isinstance(recorded[k], float))
        + f"; gates loud_corr > 0.6, pitch_corr > 0.5 ok={ok}  [{smi}]")
    log(json.dumps(dict(reproduce_vq=ev, recorded=recorded, wall_s=wall,
                        probe_step_ms=1e3 / sps, card=smi)))
    if not ok:
        raise AssertionError(f"the reproduced VQ eval misses the JAX package's gates: {ev}")
    return ev


def reproduce_distill(torch, smi, out_dir="runs/mini_proof_torch"):
    """``mini_ckpt.json``'s recipe trained on the card by the port
    (``python -m sylber_tpu_torch.mini_proof``: stage 1 4,000 steps, stage 2
    1,500, B32, 384 utterances), its eval beside the recorded one."""
    from sylber_tpu_torch import mini_proof

    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    rec = meta["train"]
    t0 = time.perf_counter()
    out = mini_proof.main(["--out-dir", out_dir, "--stage1-steps", str(rec["stage1_steps"]),
                           "--stage2-steps", str(rec["stage2_steps"]),
                           "--batch-size", str(rec["batch_size"]), "--n-utts",
                           str(rec["n_utts"]), "--device", "cuda"])
    wall = time.perf_counter() - t0
    steps = {}
    for stage in ("stage1", "stage2"):
        rows = [json.loads(ln) for ln in open(Path(out_dir) / stage / "metrics.jsonl")]
        rates = [r["steps_per_sec"] for r in rows if r["prefix"] == "train"][1:]
        steps[stage] = dict(step_ms_p50=1e3 / float(np.median(rates)),
                            wall_s=out["timing"][f"{stage}_s"], logged_windows=len(rates),
                            loss_first=rows[0]["loss"], loss_last=rows[-1]["loss"])
    ev, want = out["eval"], meta["eval"]
    for stage, r in steps.items():
        log(f"reproduce-distill {stage}: step p50 {r['step_ms_p50']:.2f} ms (windows of 100 "
            f"steps after the first), wall {r['wall_s']:.1f} s, loss {r['loss_first']:.4g} -> "
            f"{r['loss_last']:.4g}  [{smi}]")
    log(f"reproduce-distill: wall {wall:.1f} s (eval {out['timing']['eval_s']:.1f} s); learned "
        f"norm threshold {out['norm_threshold']:.4f} (recorded {meta['norm_threshold']:.4f})")
    for k in ev:
        log(f"reproduce-distill eval {k}: {ev[k]:.6g} (recorded {want[k]:.6g})")
    ok = (ev["boundary_f1_vs_truth_tol1"] >= REPRODUCE_F1_GATE
          and ev["fast_vs_exact_boundary_f1_tol0"] >= FAST_EXACT_F1_GATE)
    log(json.dumps(dict(reproduce_distill=ev, recorded=want, steps=steps, wall_s=wall,
                        norm_threshold=out["norm_threshold"], ok=ok)))
    if not ok:
        raise AssertionError(f"the reproduced distillation misses its gates (F1 vs truth >= "
                             f"{REPRODUCE_F1_GATE}, fast vs exact >= {FAST_EXACT_F1_GATE}): {ev}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON to this path")
    ap.add_argument("--only-resynthesis", action="store_true",
                    help="build the kernels and run phase 7 alone (a quicker check while "
                         "working on the resynthesis chain); prints no result line")
    ap.add_argument("--only-synthesis-training", action="store_true",
                    help="build the kernels and run phase 8 alone; prints no result line")
    ap.add_argument("--only-int8", action="store_true",
                    help="build the kernels and run phase 9 alone (the int8 serving path and "
                         "the gateloop regressor); prints no result line")
    ap.add_argument("--only-corpus", action="store_true",
                    help="build the kernels and run phase 10 alone (the offline corpus "
                         "path); prints no result line")
    ap.add_argument("--only-mesh", action="store_true",
                    help="build the kernels and run phase 11 alone (the mesh: world-size-1 "
                         "NCCL runs, two gloo ranks on the card, the Segmenter's replicas); "
                         "prints no result line")
    ap.add_argument("--only-two-cards", action="store_true",
                    help="build the kernels and run the parts of phase 11 that need two "
                         "cards (dp=2 over NCCL across cards, the Segmenter's replicas on "
                         "cuda:0 and cuda:1); fails on a machine with one card; prints no "
                         "result line")
    ap.add_argument("--only-dispatch", action="store_true",
                    help="build the kernels and run phase 12 alone (steps_per_dispatch as CUDA "
                         "graph replay, layer 0 at (8, 4) and with a bias, the bf16 "
                         "regressor, ema_fp32_shadow); prints no result line")
    ap.add_argument("--reproduce-distill", action="store_true",
                    help="build the kernels, then train mini_ckpt.json's recipe with "
                         "python -m sylber_tpu_torch.mini_proof (into runs/mini_proof_torch) "
                         "and evaluate it against the recorded eval; prints no result line")
    ap.add_argument("--reproduce-synthesis", action="store_true",
                    help="build the kernels, then train configs/sylber_resynthesis_mini.yaml "
                         "(6,000 steps) on the card and evaluate it with 50 ODE steps against "
                         "mini_synth.json's recorded eval; prints no result line")
    ap.add_argument("--only-seeding", action="store_true",
                    help="build the kernels and run the seeding kernel's records of phases 8 "
                         "and 13 alone (every seeding shape against the plain version, the "
                         "plan, the exchange's round trip, the bounds); prints no result line")
    ap.add_argument("--only-evals", action="store_true",
                    help="build the kernels and run phase 13 alone (the evaluation entry "
                         "points); prints no result line")
    ap.add_argument("--only-analyses", action="store_true",
                    help="build the kernels and run phase 14 alone (the pitch analyses, the "
                         "parity check, the seeding at its repaired widths); prints no result "
                         "line")
    ap.add_argument("--only-orbax", action="store_true",
                    help="build the kernels and run phase 15 alone (the JAX trainer's Orbax "
                         "checkpoints read by the port: the Segmenter, the resynthesis chain "
                         "and a resumed trainer on the committed fixtures); prints no result "
                         "line")
    ap.add_argument("--only-orbax-write", action="store_true",
                    help="build the kernels and run phase 16 alone (the trainer's asynchronous "
                         "Orbax saves at full width, the read-back, a resume, the Segmenter on "
                         "the written params_final/); prints no result line")
    ap.add_argument("--reproduce-tokens", action="store_true",
                    help="build the kernels, then the token chains (v1 and rich, recorded "
                         "codebooks and refit), the pitch chain and the production codebooks "
                         "beside the recorded tables, with the gates; prints no result line")
    ap.add_argument("--reproduce-vocoder", nargs="?", const="both",
                    choices=["both", "v1", "rich"],
                    help="build the kernels, then mini_vocoder.json's recipe and the rich one "
                         "(8,000 steps each; or the one named) beside the recorded evals, with "
                         "the gates; prints no result line")
    ap.add_argument("--reproduce-vq", action="store_true",
                    help="build the kernels, then train_synthesis --tokens on "
                         "configs/sylber_resynthesis_tokens_mini.yaml (12,000 steps) beside "
                         "mini_vq_synth.json's eval, with the gates; prints no result line")
    ap.add_argument("--trace-vocoder-leg", action="store_true",
                    help="build the kernels, then the recorded-codebook rows whose vocoder "
                         "f0_corr misses the recorded table: the vocoder leg under several "
                         "noise draws, in TF32 and fp32, on the art of a TF32 and an fp32 "
                         "regressor; prints no result line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sylber_tpu_torch.ops.gateloop  # noqa: F401  (the phase-9 kernels' wrappers)
    import sylber_tpu_torch.ops.int8  # noqa: F401
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
    if args.only_synthesis_training:
        synthesis_training_phase(torch, ops, counters, smi)
        return 0
    if args.reproduce_synthesis:
        reproduce_synthesis(torch, smi)
        return 0
    if args.only_corpus:
        p10 = corpus_phase(torch, counters, smi)
        log(f"phase 10: launches over the corpus path: {p10['launches']}  [{smi}]")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, corpus=p10), indent=1))
        return 0
    if args.reproduce_distill:
        reproduce_distill(torch, smi)
        return 0
    if args.only_mesh:
        p11 = mesh_phase(torch, Segmenter, HubertConfig, counters, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, mesh=p11), indent=1,
                                                 default=str))
        return 0
    if args.only_two_cards:
        if torch.cuda.device_count() < 2:
            raise SystemExit("chip_smoke --only-two-cards: the machine has one card")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
            nccl, seg2 = two_card_phases(torch, Segmenter, HubertConfig, counters, smi,
                                         Path(tmp))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, nccl=nccl, segmenter=seg2),
                                                 indent=1, default=str))
        return 0
    if args.only_dispatch:
        p12 = dispatch_phase(torch, ops, Segmenter, HubertConfig, counters, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, dispatch=p12), indent=1,
                                                 default=str))
        return 0
    if args.only_seeding:
        from sylber_tpu_torch.flow import kmeans as km

        with matmul_precision("highest"):
            recs = kmeanspp_records(torch, km, smi) + production_seeding(torch, km, smi)["timed"]
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            build_log = kernels.BUILD_DIR / "build.log"  # registers, shared memory, spills
            if build_log.exists():
                Path(args.out).with_suffix(".build.log").write_text(build_log.read_text())
            Path(args.out).write_text(json.dumps(dict(card=smi, seeding=recs), indent=1,
                                                 default=str))
        bad = [(r["name"], r["shape"]) for r in recs if not r["ok"]]
        if bad:
            raise AssertionError(f"kmeanspp failed at {bad}")
        return 0
    if args.only_evals:
        p13 = eval_phase(torch, counters, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, evals=p13), indent=1,
                                                 default=str))
        return 0
    if args.only_analyses:
        p14 = analyses_phase(torch, counters, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, analyses=p14), indent=1,
                                                 default=str))
        return 0
    if args.only_orbax:
        p15 = orbax_phase(torch, counters, Segmenter, HubertConfig, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, orbax=p15), indent=1,
                                                 default=str))
        return 0
    if args.only_orbax_write:
        p16 = orbax_write_phase(torch, counters, Segmenter, HubertConfig, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, orbax_write=p16), indent=1,
                                                 default=str))
        return 0
    if (args.reproduce_tokens or args.reproduce_vocoder or args.reproduce_vq
            or args.trace_vocoder_leg):
        reports = {}
        if args.trace_vocoder_leg:
            reports["trace_vocoder_leg"] = trace_vocoder_leg(torch, smi)
        if args.reproduce_tokens:
            reports["tokens"] = reproduce_tokens(torch, smi)
        if args.reproduce_vocoder:
            reports["vocoder"] = reproduce_vocoder(
                torch, smi, styles=("v1", "rich") if args.reproduce_vocoder == "both"
                else (args.reproduce_vocoder,))
        if args.reproduce_vq:
            reports["vq"] = reproduce_vq(torch, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, **reports), indent=1,
                                                 default=str))
        return 0
    if args.only_int8:
        p9 = int8_phase(torch, ops, counters, smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(card=smi, int8=p9), indent=1))
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
    log_pass2("phase 2", p2, smi)
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
        if "pass2" in e:
            log_pass2(f"phase 2 ({e['case']})", e["pass2"], smi)
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
        runs, launches, _ = main_path(torch, Segmenter, HubertConfig, counters)
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

    synthesis_training = synthesis_training_phase(torch, ops, counters, smi)
    log(f"phase 8: launches over the full-width CFM runs: {synthesis_training['launches']}; "
        f"kmeanspp over fit_kmeans: {synthesis_training['kmeanspp_launches']}  [{smi}]")
    launches = {k: v + synthesis_training["launches"][k] for k, v in launches.items()}

    t9 = time.perf_counter()
    int8 = int8_phase(torch, ops, counters, smi)
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s  [{smi}]")

    t10 = time.perf_counter()
    corpus = corpus_phase(torch, counters, smi)
    log(f"phase 10: launches over the corpus path: {corpus['launches']}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s  [{smi}]")
    launches = {k: v + corpus["launches"][k] for k, v in launches.items()}

    t11 = time.perf_counter()
    mesh = mesh_phase(torch, Segmenter, HubertConfig, counters, smi)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s  [{smi}]")
    launches = {k: v + mesh["launches"][k] for k, v in launches.items()}

    dispatch = dispatch_phase(torch, ops, Segmenter, HubertConfig, counters, smi)

    evals = eval_phase(torch, counters, smi)

    analyses = analyses_phase(torch, counters, smi)

    orbax = orbax_phase(torch, counters, Segmenter, HubertConfig, smi)

    orbax_write = orbax_write_phase(torch, counters, Segmenter, HubertConfig, smi)

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
                                  "mid_boundaries", "p_rows_read", "window_frames", "chains",
                                  "longest_chain") if k in r)
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
            for e in seg_edges if e["case"] in CONSUMER_SEGMENTATION]
    for rec, e in zip(entries["segment_pass2"]["consumer_shapes"],
                      [e for e in seg_edges if e["case"] in CONSUMER_SEGMENTATION]):
        rec.update({k: e["pass2"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "chain_bound_ms", "chains", "longest_chain",
                                               "mid_boundaries")})
    # the trainer's shapes (phase 6): times, bounds and the plain versions there
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "eager_ms", "bound_ms",
            "bound_by", "chain_bound_ms", "chains", "longest_chain")
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
        entry["synthesis_training_launches"] = synthesis_training["launches"][name]
        entry["corpus_launches"] = corpus["launches"][name]
        entry["mesh_launches"] = mesh["launches"][name]
    # the seeding kernel (phase 8): its main path is fit_kmeans; the headline
    # shape is the production seed pool's width at 2,000 centers
    # (bound_ms: every input read once, every output written once; the
    # design's bounds, on-chip bytes and the chain, under their own names)
    seeding = synthesis_training["kmeanspp"]
    head = next(r for r in seeding if r["name"] == "full_width")
    shape_keys = ("name", "shape", "ties", "worst_tie_gap", "non_tie_differences",
                  "identical_rows", "ms", "us_a_step", "plain_ms", "plan", "resident_share",
                  "exchange_round_trip_us", "bound_ms", "bound_by", "onchip_bound_ms",
                  "chain_bound_ms", "x_each_step_bound_ms", "inputs_once_bound_ms",
                  "cuda_launches_per_call", "ok")
    line.append(dict(name="kmeanspp", route="cuda", source="sylber_tpu_torch/csrc/kmeanspp.cu",
                     replaces="sylber_tpu/flow/kmeans.py:31",
                     launches=synthesis_training["kmeanspp_launches"],
                     max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
                     bound_ms=head["inputs_once_bound_ms"],
                     bound_by=head["inputs_once_bound_by"], library_ms=None,
                     dtype="float32", shape=head["shape"],
                     cuda_launches_per_call=head["cuda_launches_per_call"],
                     design_bound_ms=head["bound_ms"], design_bound_by=head["bound_by"],
                     onchip_bound_ms=head["onchip_bound_ms"],
                     chain_bound_ms=head["chain_bound_ms"],
                     x_each_step_bound_ms=head["x_each_step_bound_ms"],
                     ties=sum(r["ties"] for r in seeding),
                     shapes=[{k: r[k] for k in shape_keys} for r in seeding],
                     fit_kmeans=synthesis_training["fit_kmeans"]))
    # the int8 serving path's kernels and the GateLoop kernel (phase 9)
    line += int8_kernel_entries(int8)
    for entry in line[:-3]:  # the earlier kernels' launches over phase 9's runs
        entry["int8_path_launches"] = int8["launches"].get(entry["name"])
    # phase 12: the K-step run's launches (the captured step's once) and each
    # kernel's launches in the captured step, with the count of replays
    k8 = dispatch["dispatch"]["runs"]["k8"]
    for entry in line:
        entry["dispatch_launches"] = dict(
            counted=k8["launches"].get(entry["name"], 0),
            per_replay=k8["launches_per_replay"].get(entry["name"], 0),
            replays=k8["replays"])
    entries["conv0_gn_gelu"]["other_taps_k8_s4"] = dispatch["conv0_k8_s4"]
    for name, rec in dispatch["regressor_attention_bf16"].items():
        entries[name]["bf16_regressor_shape"] = rec
    # phase 13: every kernel's launches over the evaluation entry points
    # (the seeding kernel's in fit_quantizer), the seeding at the production shape
    for entry in line:
        entry["eval_launches"] = evals["launches"].get(entry["name"], 0)
    entries["kmeanspp"] = next(e for e in line if e["name"] == "kmeanspp")
    entries["kmeanspp"]["production_shape"] = [
        {k: r[k] for k in shape_keys} for r in evals["production_seeding"]["timed"]]
    gate = next(e for e in line if e["name"] == "gate_loop")
    gate["bf16_regressor_launches"] = dispatch["bf16_regressor"]["runs"][
        "bfloat16_gateloop"]["launches"]["gate_loop_operator"]
    gate["bf16_regressor_call"] = evals["gateloop_bf16"]
    # phase 14: every kernel's launches over the analyses' entry points, the
    # seeding at the widths it used to refuse
    for entry in line:
        entry["analysis_launches"] = analyses["launches"].get(entry["name"], 0)
    entries["kmeanspp"]["wide_shapes"] = [{k: r[k] for k in shape_keys}
                                          for r in analyses["wide_seeding"]]
    # phase 15: every kernel's launches over the Orbax checkpoints' card calls
    for entry in line:
        entry["orbax_launches"] = orbax["launches"].get(entry["name"], 0)
    # phase 16: every kernel's launches over the trainer writing Orbax steps
    # and the Segmenter on its params_final/
    for entry in line:
        entry["orbax_write_launches"] = orbax_write["launches"].get(entry["name"], 0)
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
                                                  resynthesis=resynthesis,
                                                  synthesis_training=synthesis_training,
                                                  int8=int8, corpus=corpus, mesh=mesh,
                                                  dispatch=dispatch, evals=evals,
                                                  analyses=analyses, orbax=orbax,
                                                  orbax_write=orbax_write),
                                             indent=1, default=str))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
