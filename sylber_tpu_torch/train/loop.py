"""Training loop: config -> data -> step loop -> checkpoints and metrics.

Port of ``sylber_tpu/train/loop.py``. The same YAML keys
(``distill_config_from_dict``); data from the synthetic corpus, uploaded
once and gathered on the device (``data.device_resident``, the default for
it), or from files, assembled on the host (``data.num_workers`` worker
processes) and copied ahead of use through pinned memory on a side stream;
metrics fetched every ``log_every`` steps into ``metrics.jsonl``; rolling
checkpoints every ``ckpt_every`` steps in the JAX trainer's Orbax layout
(``ckpts/<step>/default``, which the JAX trainer resumes), copied off the
card on the step's stream and written on a background thread, each save's
times and bytes in ``checkpoints.jsonl``, with resume (``resumed from step
N``); a Chrome trace of steps ``a`` to ``b`` with ``profile_steps=(a, b)``
(``<out_dir>/profile/trace.json``); the final student parameters as
``params_final/`` (Orbax, the JAX loop's ``save_params``) and
``params_final.npz``, both in the JAX layout.

The mesh (``mesh: {dp, mp, fsdp, fsdp_min_size}``, ``distributed:``;
``parallel/mesh.py``; FSDP shards the leaves of JAX's plan, those of at
least ``fsdp_min_size`` elements outside the convolutions): the process first joins the run's process group
(``maybe_distributed_init``: a ``distributed:`` block, the ``SYLBER_TPU_*``
variables or a torchrun launch, one process a GPU), then lays a ``dp x mp``
mesh over the ranks (``dp: -1`` fills the world; a mesh that is not the
world raises, as does a ``dp`` that does not divide the batch). Every rank
builds the same global batch from ``(seed, step)`` and keeps its rows; with
``data.device_resident`` each rank uploads the whole corpus and gathers the
global batch on its device (JAX's loop places each host's share of a
host-built batch). Rank 0 alone prints and writes ``metrics.jsonl``, the
checkpoints and ``params_final``, whose leaves are gathered whole first
(a checkpoint resumes under any mesh); the val loss is the global batch's;
MFU is over the ``dp`` cards, as in JAX.

``steps_per_dispatch: K`` runs K steps a dispatch on the device-resident
corpus (``train/dispatch.py``: on CUDA a graph of the step, captured once
and replayed K times; on the CPU the same steps eagerly), with the one-step
loop's math: the same index stream, the same per-step draws, the same
metric rows (the host fetches a dispatch's metrics once, where a step of
it is logged, and gives its rows the dispatch's rate). Steps that K does not
divide run one at a time. Checkpoints and validation fire on interval
crossings, as in JAX. As in JAX, K falls back to 1, with JAX's message,
without device-resident data or with ``profile_steps``; under a process
group too (JAX turns device-resident data off in a multi-process run).

Differences from the JAX loop: ``rng_impl`` is not ported (it is read: the
loop says that it selects a JAX generator); a resumed run is not reseeded:
the batches of step ``s`` depend on ``(seed, s)`` alone, so it sees what an
uninterrupted run sees (the JAX loop reseeds the data with
``seed + 1_000_003 * start``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from ..api import resolve_device
from ..data.dataset import (SpeechDataset, SyntheticSpeechDataset, load_manifest, prefetch,
                            step_batches)
from ..data.device import device_stream, gather_batch, index_stream, precollate, to_device, \
    wait_ready
from ..data.noise import NoiseMixerConfig
from ..io.checkpoint import (TrainCheckpointManager, jax_params_from_state_dict, save_params,
                             save_tree_npz, train_state_to_jax)
from ..models.hubert import HubertConfig
from ..parallel.mesh import (FSDP_MIN_SIZE, fetch_global, is_main, maybe_distributed_init,
                             mesh_from_config, shard_batch)
from ..utils.profiling import hubert_train_flops, mfu, trace
from .dispatch import StepDispatch
from .distill import DistillConfig, TrainState, init_train_state, make_eval_step, make_train_step

SPD_FALLBACK = ("steps_per_dispatch > 1 needs device-resident data and no profile hooks; "
                "falling back to 1")


def distill_config_from_dict(model_cfg: Dict[str, Any]) -> DistillConfig:
    """Map the recipes' ``model:`` keys onto DistillConfig."""
    m = dict(model_cfg)
    extra = {k: tuple(v) if isinstance(v, list) else v for k, v in m.get("hubert", {}).items()}
    if "frontend_dtype" in m:
        extra.setdefault("frontend_dtype", m["frontend_dtype"])
    hubert = HubertConfig(num_hidden_layers=m.get("encoding_layer", 9),
                          dtype=m.get("dtype", "float32"),
                          precision=m.get("precision", "default"), **extra)
    noise = NoiseMixerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in m.get("noise_mixer_configs", {}).items()})
    return DistillConfig(
        model=hubert,
        ema_decay=m.get("ema_decay", 1.0),
        segment_online=m.get("segment_online", False),
        merge_threshold_range=tuple(m.get("merge_threshold_range", (0.5, 0.7))),
        use_train_thrupdate=m.get("use_train_thrupdate", False),
        mask_prob=m.get("mask_prob", 0.0),
        min_mask_n=m.get("min_mask_n", 0),
        max_mask_set=m.get("max_mask_set", 1),
        do_noise_augment=m.get("do_noise_augment", False),
        noise_mixer=noise,
        lr=m.get("lr", 1e-4),
        warmup_steps=m.get("warmup_steps", 500),
        total_steps=m.get("total_steps", 200_000),
        min_factor=m.get("min_factor", 1.0),
        hold_steps=m.get("hold_steps", 0),
        loss_scale=m.get("loss_coefs", {}).get("distillation_loss", 1.0),
        accumulate_grad_batches=m.get("accumulate_grad_batches", 1),
    )


def build_dataset(data_cfg: Dict[str, Any], split: str = "train", seed: int = 0) -> SpeechDataset:
    d = dict(data_cfg)
    if d.get("synthetic"):
        return SyntheticSpeechDataset(
            n_utts=d.get("n_utts", 64), max_len=d.get("max_len", 80_000),
            with_segments=not d.get("segment_online_data", False),
            seed=seed, style=d.get("style", "v1"))
    files_key = {"train": "train_files", "valid": "val_files", "test": "test_files"}[split]
    return SpeechDataset(
        wav_dirs=d["wav_dirs"], tags=load_manifest(d[files_key]), data_dir=d.get("data_dir"),
        max_len=d.get("max_len", 80_000), dummy_len=d.get("dummy_len", 300_000),
        noise_dir=d.get("noise_dir"), seed=seed)


class MetricLogger:
    """Rows of ``{"step", "prefix", "time", metric: float, ...}`` in
    ``<out_dir>/metrics.jsonl``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> Dict:
        row = {"step": step, "prefix": prefix, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row


def _fetch(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The metrics on the host: one wait for the device."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return dict(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def train_batches(data_cfg: Dict[str, Any], batch_size: int, seed: int, start: int,
                  device: torch.device) -> Iterator[Dict[str, Optional[torch.Tensor]]]:
    """The training stream from step ``start`` on, as device tensors."""
    ds = build_dataset(data_cfg, "train", seed=seed)
    transfer = data_cfg.get("transfer", "float32")
    if data_cfg.get("device_resident", bool(data_cfg.get("synthetic"))):
        return device_stream(ds, batch_size, device, transfer=transfer, shuffle=True,
                             seed=seed, start=start)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    host = step_batches(ds, batch_size, seed, start, transfer=transfer,
                        workers=int(data_cfg.get("num_workers", 0)))
    ready = prefetch(host, transform=lambda b: to_device(b, device, side))
    return (wait_ready(b, ev) for b, ev in ready)


def _val_batches(data_cfg: Dict[str, Any], batch_size: int, seed: int, device: torch.device,
                 limit: int):
    """At most ``limit`` ordered validation batches on the device."""
    val_bs = data_cfg.get("val_batch_size") or batch_size
    transfer = data_cfg.get("transfer", "float32")
    vds = build_dataset(data_cfg, "valid", seed=seed)
    if data_cfg.get("device_resident", bool(data_cfg.get("synthetic"))):
        data = precollate(vds, device, transfer=transfer)
        return [{k: (v[i0:i0 + val_bs] if v is not None else None) for k, v in data.items()}
                for i0 in range(0, len(vds) - val_bs + 1, val_bs)][:limit]
    return [to_device(b, device)[0] for b, _ in
            zip(vds.batches(val_bs, shuffle=False, transfer=transfer), range(limit))]


def train(cfg: Dict[str, Any], out_dir: str = "runs/sylber", max_steps: Optional[int] = None,
          log_every: int = 50, ckpt_every: int = 1000, val_every: Optional[int] = None,
          limit_val_batches: int = 100, init_params: Optional[Dict[str, torch.Tensor]] = None,
          device=None, profile_steps: Optional[Tuple[int, int]] = None,
          max_to_keep: int = 5) -> TrainState:
    """Train from the recipe dict ``cfg`` (the JAX loop's keys) on ``device``
    (``cuda`` unless the caller asks for the CPU, ``cuda:LOCAL_RANK`` in a
    process group; raises without a GPU). ``init_params``: a HubertModel
    state dict for the student and teacher. ``profile_steps=(a, b)``: trace
    steps ``a`` to ``b`` (0-based, both included) into
    ``<out_dir>/profile`` (rank 0's). ``max_to_keep``: the checkpoints kept;
    the JAX trainer's 5 unless a caller asks for fewer (only ``chip_smoke.py``
    phase 16 does, to keep its disk small). The command line has no such flag."""
    maybe_distributed_init(cfg.get("distributed"), device)
    device = resolve_device(device)
    mesh_cfg = dict(cfg.get("mesh") or {})
    mesh = mesh_from_config(mesh_cfg, device)
    dp = mesh.dp if mesh is not None else 1
    main = is_main()
    model_cfg = dict(cfg.get("model", {}))
    if "accumulate_grad_batches" in cfg:
        model_cfg.setdefault("accumulate_grad_batches", cfg["accumulate_grad_batches"])
    dcfg = distill_config_from_dict(model_cfg)
    data_cfg = cfg.get("data", {})
    batch_size = data_cfg.get("batch_size", 8)
    max_steps = max_steps or cfg.get("max_steps", dcfg.total_steps)
    seed = int(cfg.get("seed", 0))
    if batch_size % dp:
        raise ValueError(f"mesh dp={dp} does not divide the batch of {batch_size}")
    if main and cfg.get("rng_impl", "threefry") not in ("threefry", "threefry2x32"):
        print(f"rng_impl {cfg['rng_impl']!r} selects a JAX generator; ignored here")
    spd = int(cfg.get("steps_per_dispatch", 1))
    resident = data_cfg.get("device_resident", bool(data_cfg.get("synthetic")))
    if spd > 1 and (not resident or profile_steps or mesh is not None):
        if main:
            print(SPD_FALLBACK)
        spd = 1
    if main and mesh is not None:
        print(f"mesh: dp={mesh.dp} mp={mesh.mp}{' fsdp' if mesh_cfg.get('fsdp') else ''} over "
              f"{dist.get_world_size()} ranks ({dist.get_backend()})")

    state = init_train_state(dcfg, device, params=init_params,
                             thresholder_kwargs=model_cfg.get("thresholder_configs") or {},
                             seed=seed, mesh=mesh,
                             fsdp=bool(mesh_cfg.get("fsdp", False)) and mesh is not None,
                             fsdp_min_size=int(mesh_cfg.get("fsdp_min_size", FSDP_MIN_SIZE)))
    mgr = TrainCheckpointManager(os.path.join(out_dir, "ckpts"), max_to_keep=max_to_keep)
    names = [n for n, _ in state.student.named_parameters()]
    if mgr.latest_step is not None:  # the port's step, or the JAX trainer's
        state.load_state_dict(mgr.restore(param_names=names))
        if main:
            print(f"resumed from step {state.step}")
    start = state.step
    logger = MetricLogger(out_dir) if main else None
    step_fn = make_train_step(dcfg, mesh)
    eval_fn = make_eval_step(dcfg, mesh)
    dispatcher = idx_gen = data = None
    if spd > 1:  # the corpus on the device, gathered by the dispatches' index vectors
        ds = build_dataset(data_cfg, "train", seed=seed)
        if len(ds) < batch_size:
            raise ValueError(f"dataset has {len(ds)} items < batch_size {batch_size}; the "
                             "drop-last epoch loop would yield none")
        data = precollate(ds, device, transfer=data_cfg.get("transfer", "float32"))
        idx_gen = index_stream(len(ds), batch_size, shuffle=True, seed=seed, start=start)
        dispatcher = StepDispatch(step_fn, dcfg, data, batch_size, spd, device)
        stream = (gather_batch(data, next(idx_gen), device) for _ in itertools.count())
    else:
        stream = (shard_batch(b, mesh)
                  for b in train_batches(data_cfg, batch_size, seed, start, device))

    def log_row(step, m, crop_len, steps_per_sec=None):
        """A row of host metrics; the rate since the last row unless given
        (a dispatch's rows share its rate)."""
        nonlocal t_last, s_last
        if steps_per_sec is None:
            now = time.perf_counter()
            steps_per_sec = (step - s_last) / max(now - t_last, 1e-9)
            t_last, s_last = now, step
        m["steps_per_sec"] = steps_per_sec
        m["mfu"] = mfu(hubert_train_flops(dcfg.model, batch_size, crop_len),
                       1.0 / max(m["steps_per_sec"], 1e-9),
                       str(dcfg.model.dtype).replace("torch.", ""), dcfg.model.precision, dp)
        if not main:
            return
        row = logger.log(step, m)
        print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in row.items()
                                        if k not in ("time", "prefix")))

    t_last, s_last = time.perf_counter(), start
    val_batches = None
    step_i = start
    with contextlib.ExitStack() as tracer:  # closed after step b, or on an error
        while step_i < max_steps:
            if dispatcher is not None and step_i + spd <= max_steps:
                ms = dispatcher.dispatch(state, seed, [next(idx_gen) for _ in range(spd)])
                s_end = step_i + spd
                logged = [s for s in range(step_i + 1, s_end + 1) if s % log_every == 0]
                if logged:
                    rows = ms.cpu().tolist()  # the dispatch's one wait for its metrics
                    now = time.perf_counter()
                    sps = (s_end - s_last) / max(now - t_last, 1e-9)
                    t_last, s_last = now, s_end
                    crop = data["input_values"].shape[-1]
                    for s in logged:
                        log_row(s, dict(zip(dispatcher.keys, rows[s - step_i - 1])), crop, sps)
            else:
                if profile_steps and step_i == profile_steps[0] and main:
                    tracer.enter_context(trace(os.path.join(out_dir, "profile")))
                batch = next(stream)
                metrics = step_fn(state, batch, seed)
                if profile_steps and step_i == profile_steps[1]:
                    tracer.close()
                s_end = step_i + 1
                if s_end % log_every == 0:
                    # waits for the device: only every log_every steps
                    log_row(s_end, _fetch(metrics), batch["input_values"].shape[-1])
            if ckpt_every and step_i // ckpt_every != s_end // ckpt_every:
                # every rank gathers its pieces; without a mesh, the live tensors
                full = state.state_dict()
                if main:
                    mgr.save(s_end, train_state_to_jax(full, names, dcfg),
                             marker={"data_seed": seed})
            if val_every and step_i // val_every != s_end // val_every:
                if val_batches is None:  # built once, kept on the device
                    val_batches = [shard_batch(vb, mesh) for vb in _val_batches(
                        data_cfg, batch_size, seed + 1, device, limit_val_batches)]
                losses = [eval_fn(state, vb, seed + 1 + i)["loss"]
                          for i, vb in enumerate(val_batches)]
                if losses and main:
                    loss = float(torch.stack(losses).mean())
                    logger.log(s_end, {"loss": loss}, prefix="val")
                    print(f"  val loss: {loss:.4f}")
            step_i = s_end

    mgr.close()  # the last write ended; a failed write raises here
    if main and mgr.records:
        with open(os.path.join(out_dir, "checkpoints.jsonl"), "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in mgr.records)
    final = fetch_global(state.student.state_dict(), mesh) if mesh is not None \
        else state.student.state_dict()
    if main:
        tree = jax_params_from_state_dict(final)
        save_tree_npz(os.path.join(out_dir, "params_final.npz"), tree)
        save_params(os.path.join(out_dir, "params_final"), tree)
    if mesh is not None:
        dist.barrier()  # the outputs exist when any rank returns
    return state
