"""Stage-2 distillation: the step of ``train/distill.py::make_train_step``.

Set-up makes the corpus (crops sliced from a pool of synthetic speech,
white-noise clips drawn on the device, both as peak-scaled int16 PCM in
device memory, the layout of ``data/device.py::precollate``), builds one
training state from the benchmark's seeded weights and one
``train/dispatch.py::StepDispatch`` at ``steps_per_dispatch``, and drives
that same object through its first steps with its own ``dispatch`` call
on rows that all differ: step 1 alone (eager), steps 2-3 (the capture of
the step's CUDA graph and a replay), then one whole dispatch. The first
gradient as AdamW got it (its first moment after step 1 over ``1 - beta1``)
and each parameter's change after step 3 are read on the way.

The window is a loop of dispatches of K steps on rows drawn from the seed
(a permutation of the corpus an epoch); each dispatch's metrics are copied
to pinned memory behind its steps and read once the next dispatch is
enqueued (the dispatch itself waits for the one before), and the window
ends at the synchronise after its last step. The
host's clock times each ``dispatch`` call (the span ``dispatch``). With
``trace`` two more dispatches run after the window under the profiler.

The check: the reference (``reference/distill.py``) runs the first three
steps from the same weights on the same rows with the same draws, and each
step's loss and segment count, the first gradient's norm and the change's
norm a leaf are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np

from ..flops import peak_flops, train_step_flops
from ..outcome import Outcome
from ..profile import HOST_SPAN, traced
from ..reference import distill as ref_distill
from ..reference import hubert as ref_hubert
from ..reference.precision import fp8
from ..traffic import corpus
from ..weights import seeded_weights
from .segment import _device_info, hubert_config

CHECKED_STEPS = 3


def distill_config(cfg: Dict[str, Any]):
    from sylber_tpu_torch.data.noise import NoiseMixerConfig
    from sylber_tpu_torch.train.distill import DistillConfig

    noise = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg["noise_mixer_configs"].items()}
    return DistillConfig(
        model=hubert_config(cfg), ema_decay=cfg["ema_decay"],
        segment_online=cfg["segment_online"],
        merge_threshold_range=tuple(cfg["merge_threshold_range"]),
        use_train_thrupdate=cfg["use_train_thrupdate"], thresholder_decay=cfg["thresholder_decay"],
        mask_prob=cfg["mask_prob"], min_mask_n=cfg["min_mask_n"],
        do_noise_augment=cfg["do_noise_augment"], noise_mixer=NoiseMixerConfig(**noise),
        lr=cfg["lr"], warmup_steps=cfg["warmup_steps"], total_steps=cfg["total_steps"],
        min_factor=cfg["min_factor"], hold_steps=cfg["hold_steps"],
        weight_decay=cfg["weight_decay"], grad_clip=cfg["grad_clip"],
        loss_scale=cfg["loss_coefs"]["distillation_loss"],
        accumulate_grad_batches=cfg["accumulate_grad_batches"])


def pcm16(x):
    """Rows peak-scaled to int16 PCM, as the int16 transfer ships them."""
    import torch

    peak = x.abs().amax(-1, keepdim=True).clamp_min(1e-9)
    return torch.clamp(torch.round(x * (32767.0 / peak)), -32767, 32767).to(torch.int16)


def make_corpus(traffic: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """``crops`` rows of ``crop_s`` seconds, each a slice of the pool at an
    offset drawn from the seed, and as many noise clips (normal, 0.1),
    on the device as int16 PCM; the mask (int8) all ones."""
    import torch

    n = int(traffic["crop_s"] * 16000)
    pool = corpus.speech_pool(seed, traffic["pool"], traffic["pool_s"])
    r = corpus.rng(seed, corpus.SLICES)
    rows = np.stack([pool[r.randint(len(pool))][o: o + n] for o in
                     (r.randint(0, int(traffic["pool_s"] * 16000) - n + 1)
                      for _ in range(traffic["crops"]))])
    wav = torch.from_numpy(rows).to(device)
    gen = torch.Generator(device=device).manual_seed(corpus.torch_seed(seed, corpus.NOISE))
    noise = torch.randn(wav.shape, generator=gen, device=device) * 0.1
    return {"input_values": pcm16(wav), "noise": pcm16(noise),
            "attention_mask": torch.ones(wav.shape, dtype=torch.int8, device=device)}


def row_order(seed: int, crops: int, batch: int):
    """Batches of rows: a permutation of the corpus an epoch, drawn from the
    seed, cut into batches (the rows of one batch all differ)."""
    r = corpus.rng(seed, corpus.ORDER)
    while True:
        perm = r.permutation(crops)
        for i in range(0, crops - batch + 1, batch):
            yield perm[i:i + batch]


def leaf_gap(got: Dict[str, float], want: Dict[str, float], names: List[str]) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    if not names:
        return 0.0
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)


def compare(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The numbers the check compares (the worst step's loss and segment
    count, the worst leaf's first gradient and change), and more for the
    record. Leaves whose first gradient in the reference is nought to
    rounding are left out of the change."""
    names = list(want["grad1"])
    raw = want["grad1_raw"]
    med = float(np.median(list(raw.values())))
    moved = [n for n in names if raw[n] >= 1e-3 * med]  # nought to rounding: left out
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    return {
        "loss_gap": max(rel(a, b) for a, b in zip(got["loss"], want["loss"])),
        "segments_gap": max(rel(a, b) for a, b in zip(got["num_segments"],
                                                       want["num_segments"])),
        "grad_gap": leaf_gap(got["grad1"], want["grad1"], names),
        "update_gap": leaf_gap(got["change"], want["change"], moved),
        "leaves_left_out": float(len(names) - len(moved)),
        "loss_program_1": got["loss"][0], "loss_reference_1": want["loss"][0],
    }


def run(cell, seed: int, seconds: float, trace: bool, device: str, started: float) -> Outcome:
    import torch

    from sylber_tpu_torch.models.hubert import HubertModel
    from sylber_tpu_torch.train.dispatch import StepDispatch
    from sylber_tpu_torch.train.distill import init_train_state, make_train_step

    cfg, traffic = cell.config, cell.workload["traffic"]
    dev = torch.device(device)
    B, K = traffic["batch"], traffic["steps_per_dispatch"]
    dcfg = distill_config(cfg)
    shapes = {k: tuple(v.shape) for k, v in HubertModel(dcfg.model).state_dict().items()}
    weights = seeded_weights(shapes, corpus.torch_seed(seed, corpus.WEIGHTS), dev)
    data = make_corpus(traffic, seed, dev)
    state = init_train_state(dcfg, dev, params=weights,
                             thresholder_kwargs=cfg["thresholder_configs"], seed=seed)
    disp = StepDispatch(make_train_step(dcfg), dcfg, data, B, K, dev)
    order = row_order(seed, traffic["crops"], B)
    first_rows = [next(order) for _ in range(CHECKED_STEPS)]
    names = [n for n, _ in state.student.named_parameters()]
    params = dict(state.student.named_parameters())
    beta1 = cfg["betas"][0]

    # steps 1 to 3 through the window's own call, read on the way
    got: Dict[str, Any] = {}
    m1 = disp.dispatch(state, seed, np.stack(first_rows[:1]))
    rows = m1.tolist()
    # a state that a step left unchanged has no moments: nought
    moments = [state.optimizer.state[params[n]].get("exp_avg", torch.zeros_like(params[n]))
               for n in names]
    got["grad1"] = dict(zip(names, (torch.stack(torch._foreach_norm(moments)) / (1 - beta1))
                            .cpu().tolist()))
    m23 = disp.dispatch(state, seed, np.stack(first_rows[1:]))
    rows += m23.tolist()
    got["change"] = dict(zip(names, torch.stack(torch._foreach_norm(
        [params[n].detach() - weights[n] for n in names])).cpu().tolist()))
    keys = disp.keys
    got["loss"] = [float(r[keys.index("loss")]) for r in rows]
    got["num_segments"] = [float(r[keys.index("num_segments")]) for r in rows]
    disp.dispatch(state, seed, np.stack([next(order) for _ in range(K)])).cpu()
    peak_setup = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak_setup = torch.cuda.max_memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    spans = {"dispatch": []}
    counts = {"steps": 0, "failed": 0}

    def loop(stop, record=True):
        """Dispatches until ``stop(dispatches)``. Each dispatch's metrics are
        copied to pinned memory behind its steps (before the next dispatch's)
        and read once the next dispatch is enqueued; the last after a
        synchronise."""
        prev, n = None, 0
        while not stop(n):
            rows = np.stack([next(order) for _ in range(K)])
            t = time.perf_counter()
            with torch.profiler.record_function(HOST_SPAN + "dispatch"):
                ms = disp.dispatch(state, seed, rows)
            if record:
                spans["dispatch"].append(time.perf_counter() - t)
            fetched = start_fetch(ms)
            n += 1
            if prev is not None:
                take(prev, record)
            prev = fetched
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if prev is not None:
            take(prev, record)

    def start_fetch(ms):
        if dev.type != "cuda":
            return ms.clone(), None
        host = torch.empty(ms.shape, dtype=ms.dtype, pin_memory=True)
        host.copy_(ms, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def take(fetched, record):
        vals, done = fetched
        if done is not None:
            done.synchronize()
        if record:
            counts["steps"] += vals.shape[0]
            counts["failed"] += int((~torch.isfinite(vals).all(-1)).sum())

    window_start = time.perf_counter()
    setup_s = window_start - started
    loop(lambda n: time.perf_counter() - window_start >= seconds)
    window_s = time.perf_counter() - window_start
    peak_window = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    trace_summary, traced_calls = None, []
    if trace:
        dispatches = traffic["traced_dispatches"]
        trace_summary = traced(lambda: loop(lambda n: n >= dispatches, record=False))
        crop = int(traffic["crop_s"] * 16000)
        traced_calls = [(B, crop, [crop] * B)] * (dispatches * K)
    peak = max(peak_setup, torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" else 0
    steps = counts["steps"]
    crop_s = float(traffic["crop_s"])
    observed = {
        "spans": spans, "window_s": window_s, "steps": steps, "steps_per_dispatch": K,
        "flops": train_step_flops(cfg, B, int(crop_s * 16000)) * steps,
        "peak_flops": peak_flops(cfg["dtype"], cfg["precision"]) * cell.workload["chips"],
        "peak_mem_bytes_window": peak_window, "traced_calls": traced_calls,
        "config": cfg, "frames": lambda n: ref_hubert.num_frames(cfg, n),
        "trace": trace_summary,
    }

    def check():
        nonlocal state, disp
        state = disp = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        batches = [{k: v[torch.as_tensor(r, device=dev)] for k, v in data.items()}
                   for r in first_rows]
        want = ref_distill.run_steps(weights, cfg, batches, seed)
        program = got
        stand_in = cfg.get("_stand_in")  # the control or a fault, in the program's place
        if stand_in == "fp8":
            program = ref_distill.run_steps(weights, cfg, batches, seed, cast=fp8)
        elif stand_in == "half_batch":
            program = ref_distill.run_steps(weights, cfg, batches, seed,
                                            batch_rows=slice(0, B // 2))
        numbers = compare(program, want)
        limits = cell.workload["check"]["limits"]
        return [(k, numbers[k], limits[k]) for k in limits], numbers

    return Outcome(
        end_to_end={"train_audio_s_per_s": steps * B * crop_s / window_s, "setup_s": setup_s},
        observed=observed, attempted=steps, failed=counts["failed"],
        memory_peak_bytes=int(peak), trace=trace_summary, check=check,
        device=_device_info(torch, dev, cell.workload["chips"]))
