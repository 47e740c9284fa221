"""Corpus segmentation: ``Segmenter.process_async`` and ``finalize``.

Set-up builds the configuration's ``Segmenter``, writes the benchmark's
seeded weights into it, makes the corpus (a pool of synthetic speech, one
slice of it an utterance, the lengths of the mix longest first, cut into
batches) and runs the corpus once through the window's loop (every batch
shape, and the host's memory faulted in). The window is a closed
loop over the batches, cycled: batch i + 1 is enqueued (``process_async``)
before batch i is finalized, so ``in_flight`` batches are on their way at
once; the host's clock times each call (the spans ``enqueue`` and
``finalize``). The window closes at the first finalize after ``seconds``
and the batches still in flight are finalized inside it.

Two rates come of the window's batches, both over their unpadded audio:
``segment_device_rtfx`` (end to end) over the card's seconds in the
forward, segmentation and pooling of each batch, CUDA events on the stream
around ``_forward_segment``; ``wall_rtfx.segment`` (per layer) over the
window's wall. The host's padding and pageable copies set the wall's pace,
and a shared host makes it vary from process to process by more than the
largest bound; the card's time at these fixed shapes does not.

With ``trace`` one more cycle of the corpus runs after the window under the
profiler, with the same loop.

The check, after the window: the program's segments, segment features and
frame norms of a sample of utterances drawn from the seed (the longest
among them), against the plain reference (``reference/``) run on the same
weights and the same padded rows, in the configuration's precision, on the
same device.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Any, Dict, List

import numpy as np

from ..outcome import Outcome
from ..reference import hubert as ref_hubert
from ..reference import segment as ref_segment
from ..traffic import corpus
from ..flops import inference_flops, peak_flops
from ..profile import HOST_SPAN, traced
from ..weights import seeded_weights


def _device_info(torch, device, chips):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": chips}


def hubert_config(cfg: Dict[str, Any]):
    """The program's ``HubertConfig`` for a configuration file."""
    from sylber_tpu_torch.models.hubert import HubertConfig

    return HubertConfig(
        hidden_size=cfg["hidden_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"], conv_dim=tuple(cfg["conv_dim"]),
        conv_stride=tuple(cfg["conv_stride"]), conv_kernel=tuple(cfg["conv_kernel"]),
        conv_bias=cfg["conv_bias"], num_conv_pos_embeddings=cfg["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=cfg["num_conv_pos_embedding_groups"],
        layer_norm_eps=cfg["layer_norm_eps"], dtype=cfg["dtype"],
        frontend_dtype=cfg["frontend_dtype"], precision=cfg["precision"],
        int8_encoder=cfg.get("int8_encoder", False))


def make_batches(traffic: Dict[str, Any], seed: int, length_bucket: int):
    """The corpus cut into batches: ``[(wavs, lengths, padded_len)]``."""
    lengths = corpus.lognormal_lengths(traffic["utterances"], traffic["median_s"],
                                       traffic["log_sigma"], traffic["min_s"], traffic["max_s"])
    pool = corpus.speech_pool(seed, traffic["pool"], traffic["pool_s"])
    wavs = corpus.slices(seed, pool, lengths)
    bs = traffic["batch"]
    out = []
    for i in range(0, len(wavs), bs):
        lens = [len(w) for w in wavs[i:i + bs]]
        padded = -(-max(max(lens), 400) // length_bucket) * length_bucket
        out.append((wavs[i:i + bs], lens, padded))
    return out


def malformed(out: Dict[str, np.ndarray], frames: int) -> bool:
    """Whether one utterance's answer breaks its form: segments ordered,
    inside ``[0, frames]``, not overlapping; features and norms finite."""
    seg, feats, norms = out["segments"], out["segment_features"], out["frame_norms"]
    if norms.shape != (frames,) or not np.isfinite(norms).all():
        return True
    if len(seg) == 0:
        return False
    return not (feats.shape[0] == len(seg) and np.isfinite(feats).all()
                and (seg[:, 0] < seg[:, 1]).all() and seg.min() >= 0 and seg.max() <= frames
                and (seg[1:, 0] >= seg[:-1, 1]).all())


def boundary_f1(got: np.ndarray, want: np.ndarray) -> float:
    """F1 of the sets of boundary frames (starts and ends), exact match."""
    g = set(got.reshape(-1).tolist())
    w = set(want.reshape(-1).tolist())
    if not g and not w:
        return 1.0
    hit = len(g & w)
    return 2.0 * hit / (len(g) + len(w))


def compare(cfg, weights, sample, outputs, device) -> Dict[str, float]:
    """The reference over each sampled utterance (its padded row), computed
    in the configuration's precision, against the program's answer for it.
    ``utterance_gap``: the mean over the utterances of the gap between the
    program's and the reference's utterance features (each segment's
    feature weighted by its frames, both over the program's segments), over
    the reference's; ``boundary_miss``: the mean over the utterances of
    1 - F1 of the boundary frames, the reference segmenting its own states;
    ``feature_gap_max``: the largest relative gap of one segment's feature
    (the program's against the reference's states pooled over the program's
    segment); ``norm_gap``: the largest relative gap of a frame norm. The
    other numbers are for the record."""
    import torch

    utt, per_seg, miss, norm_gap, nseg = [], [], [], 0.0, [0, 0]
    for key, (wav, n, padded) in sample.items():
        got = outputs[key]
        segs = got["segments"]
        row = torch.zeros(1, padded, device=device)
        row[0, :n] = torch.from_numpy(wav).to(device)
        frames = ref_hubert.num_frames(cfg, n)
        states = ref_hubert.forward(weights, cfg, row, [n],
                                    dtype=cfg["dtype"])[0, :frames].cpu().numpy()
        # the program's pooling over its own segments, against the
        # reference's states pooled over the same spans
        pooled = ref_segment.pool(states, segs)
        if not len(pooled):  # an answer without segments shares nothing
            utt.append(1.0)
        else:
            lens = (segs[:, 1] - segs[:, 0]).astype(np.float64)[:, None]
            utt_p = (got["segment_features"] * lens).sum(0) / lens.sum()
            utt_r = (pooled * lens).sum(0) / lens.sum()
            utt.append(np.linalg.norm(utt_p - utt_r) / max(np.linalg.norm(utt_r), 1e-12))
            per_seg.append(np.linalg.norm(got["segment_features"] - pooled, axis=-1)
                           / np.maximum(np.linalg.norm(pooled, axis=-1), 1e-12))
        norms = ref_segment.frame_norms(states)
        norm_gap = max(norm_gap, float(np.max(np.abs(got["frame_norms"] - norms) / norms)))
        want = ref_segment.segment(states, cfg["norm_threshold"], cfg["merge_threshold"])
        miss.append(1.0 - boundary_f1(segs, want))
        nseg[0] += len(segs)
        nseg[1] += len(want)
    rel = np.concatenate(per_seg) if per_seg else np.zeros(1)
    return {"utterance_gap": float(np.mean(utt)), "utterance_gap_max": float(np.max(utt)),
            "boundary_miss": float(np.mean(miss)), "boundary_miss_max": float(np.max(miss)),
            "norm_gap": norm_gap, "feature_gap_mean": float(rel.mean()),
            "feature_gap_max": float(rel.max()), "segments_program": nseg[0],
            "segments_reference": nseg[1]}


def _half_rows_left_out(seg) -> None:
    """A fault: the second half of each batch's rows never reaches the
    encoder (zeros in their place)."""
    forward = seg._forward_segment

    def left_out(wavs, mask, *a):
        wavs = wavs.clone()
        wavs[wavs.shape[0] // 2:] = 0
        return forward(wavs, mask, *a)
    seg._forward_segment = left_out


def _answer_altered(seg) -> None:
    """A fault: each answer's segments merged in pairs where it is produced,
    its features kept."""
    collect = seg._collect

    def altered(*a, **k):
        outs = collect(*a, **k)
        for o in outs:
            s, n = o["segments"], len(o["segments"])
            o["segments"] = np.array([[s[i, 0], s[min(i + 1, n - 1), 1]]
                                      for i in range(0, n, 2)], np.int64).reshape(-1, 2)
            o["segment_features"] = o["segment_features"][::2]
        return outs
    seg._collect = altered


def _features_shifted(seg) -> None:
    """A fault in the pooling: each answer's segment features moved by one
    segment where they are produced (segment i gets the feature of segment
    i - 1, the first that of the last), its segments and norms kept."""
    collect = seg._collect

    def shifted(*a, **k):
        outs = collect(*a, **k)
        for o in outs:
            if len(o["segments"]):
                o["segment_features"] = np.roll(o["segment_features"], 1, axis=0)
        return outs
    seg._collect = shifted


# faults planted under the timed path by ``readings.py --stand-in`` and the tests
FAULTS = {"half_rows": _half_rows_left_out, "altered": _answer_altered,
          "shifted": _features_shifted}


def run(cell, seed: int, seconds: float, trace: bool, device: str, started: float) -> Outcome:
    import torch

    from sylber_tpu_torch.api import Segmenter

    cfg, traffic = cell.config, cell.workload["traffic"]
    dev = torch.device(device)
    bucket = int(traffic["length_bucket_s"] * 16000)
    seg = Segmenter(hubert_config=hubert_config(cfg), norm_threshold=cfg["norm_threshold"],
                    merge_threshold=cfg["merge_threshold"],
                    length_bucket_s=traffic["length_bucket_s"],
                    batch_buckets=(traffic["batch"],), device=dev)
    shapes = {k: tuple(v.shape) for k, v in seg.model.state_dict().items()}
    weights = seeded_weights(shapes, corpus.torch_seed(seed, corpus.WEIGHTS), dev)
    seg.model.load_state_dict(weights)
    if cfg.get("_stand_in") in FAULTS:
        FAULTS[cfg["_stand_in"]](seg)
    batches = make_batches(traffic, seed, bucket)
    # the sample the check compares: the longest utterance and others drawn
    # from the seed, as (batch, row)
    flat = [(b, r) for b, (w, _, _) in enumerate(batches) for r in range(len(w))]
    pick = corpus.rng(seed, corpus.SAMPLE).choice(len(flat), cell.workload["check"]["sample"] - 1,
                                                  replace=False)
    sample = {(0, 0): None, **{flat[i]: None for i in pick}}
    sample = {k: (batches[k[0]][0][k[1]], batches[k[0]][1][k[1]], batches[k[0]][2])
              for k in sample}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the card's time in each window batch's forward, segmentation and
    # pooling: CUDA events on the stream around ``_forward_segment`` (the
    # uploads are enqueued before it, the copies to the host after it); on
    # the CPU, where the call runs synchronously, the host's clock
    forward_times: List[Any] = []
    forward = seg._forward_segment

    def timed_forward(*a):
        if not timing:
            return forward(*a)
        if dev.type != "cuda":
            t = time.perf_counter()
            out = forward(*a)
            forward_times.append(time.perf_counter() - t)
            return out
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = forward(*a)
        end.record()
        forward_times.append((start, end))
        return out
    seg._forward_segment = timed_forward
    timing = False

    spans = {"enqueue": [], "finalize": []}
    outputs, counts = {}, {"done": 0, "failed": 0, "audio_samples": 0, "flops": 0.0}
    batch_flops = [inference_flops(cfg, lens) for _, lens, _ in batches]
    frames = lambda n: ref_hubert.num_frames(cfg, n)  # noqa: E731

    def loop(stop, record=True):
        """The closed loop: enqueue batches until ``stop(enqueued)`` holds,
        finalizing the oldest whenever ``in_flight`` are on their way; then
        finalize the rest."""
        pending = deque()

        def finalize_oldest():
            b, lens, fin = pending.popleft()
            t = time.perf_counter()
            with torch.profiler.record_function(HOST_SPAN + "finalize"):
                outs = fin()
            if not record:
                return
            spans["finalize"].append(time.perf_counter() - t)
            counts["audio_samples"] += sum(lens)
            counts["flops"] += batch_flops[b]
            for r, (o, n) in enumerate(zip(outs, lens)):
                counts["done"] += 1
                counts["failed"] += malformed(o, frames(n))
                if (b, r) in sample:
                    outputs[(b, r)] = o

        i = 0
        while not stop(i):
            wavs, lens, _ = batches[i % len(batches)]
            t = time.perf_counter()
            with torch.profiler.record_function(HOST_SPAN + "enqueue"):
                fin = seg.process_async(wavs, in_second=False,
                                        return_hidden=traffic["return_hidden"])
            if record:
                spans["enqueue"].append(time.perf_counter() - t)
            pending.append((i % len(batches), lens, fin))
            i += 1
            if len(pending) >= traffic["in_flight"]:
                finalize_oldest()
        while pending:
            finalize_oldest()

    # warm-up: the corpus once, through the window's loop: every padded
    # length, and the host's heap grown to what the window's batches take
    loop(lambda i: i >= len(batches), record=False)
    sync()
    peak_setup = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    timing = True
    window_start = time.perf_counter()
    setup_s = window_start - started
    loop(lambda i: time.perf_counter() - window_start >= seconds)
    window_s = time.perf_counter() - window_start
    timing = False
    # every event of the window has completed: each batch was finalized
    forward_s = sum(t if isinstance(t, float) else t[0].elapsed_time(t[1]) / 1e3
                    for t in forward_times)
    peak_window = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0

    trace_summary, traced_calls = None, []
    if trace:
        trace_summary = traced(lambda: loop(lambda i: i >= len(batches), record=False))
        traced_calls = [(traffic["batch"], L, lens) for _, lens, L in batches]
    peak = max(peak_setup, torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" else 0
    audio_s = counts["audio_samples"] / 16000.0
    observed = {
        "spans": spans, "window_s": window_s, "audio_s": audio_s, "forward_s": forward_s,
        "flops": counts["flops"],
        "peak_flops": peak_flops(cfg["dtype"], cfg["precision"]),
        "peak_mem_bytes_window": peak_window, "traced_calls": traced_calls,
        "config": cfg, "frames": frames, "trace": trace_summary,
    }

    def check():
        nonlocal seg
        # the sampled answers that were due in the window (all of them once
        # the window holds a cycle of the corpus; the longest always)
        due = {k: v for k, v in sample.items() if k in outputs}
        seg = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = compare(cfg, weights, due, outputs, dev)
        limits = cell.workload["check"]["limits"]
        return [(k, numbers[k], lim) for k, lim in limits.items()], numbers

    return Outcome(
        end_to_end={"segment_device_rtfx": audio_s / forward_s, "setup_s": setup_s},
        observed=observed, attempted=counts["done"], failed=counts["failed"],
        memory_peak_bytes=int(peak), trace=trace_summary, check=check,
        device=_device_info(torch, dev, cell.workload["chips"]))
