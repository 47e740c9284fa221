"""Resynthesis (``SegmentSynthesis``) training, start to end.

Port of ``sylber_tpu/train/synthesis_loop.py``:

1. a (wav, art) corpus: the synthetic syllabic corpus with analytic
   articulatory ground truth (``data/synthetic.py``; log-pitch, frame-RMS
   loudness), as no LibriSpeech + SPARC is in the repository;
2. the conditioning features, once, with the frozen encoder
   (:func:`precompute_features`: HuBERT, the segmentation kernels, the
   averaged fill; the explicit pitch channel where the model takes it),
   kept on the device;
3. ``synthesis.py::make_synthesis_train_step`` over batches the device
   gathers by index, in the order JAX's loop takes them
   (``RandomState(seed + 1)``), reading the device only every
   ``log_every`` steps;
4. the held-out gate (:func:`evaluate_synthesis`): sampled trajectories
   against the ground-truth pitch and loudness.

Artifacts in ``out_dir``: ``synthesis_final.npz`` (the ``hubert``,
``input_mlp`` and ``regressor`` trees in the JAX layout, which the JAX
package's ``load_params_npz`` and the port's ``SegmentSynthesis`` read),
``eval.json`` and ``metrics.jsonl``. The JAX loop writes an Orbax directory
instead (intended difference (y), ``ROADMAP.md`` section 3), which the port
reads (``io/orbax.py``) but does not write.

Data parallelism (``mesh: {dp}``, ``distributed:``; JAX's
``synthesis_loop.py:286-356``): the process joins the run's process group
(``parallel/mesh.py::maybe_distributed_init``, one process a GPU), every
rank precomputes the whole corpus's features and keeps the state
replicated, each step's batch is cut into the ranks' rows, the gradients
are averaged over ``dp``; rank 0 alone logs, evaluates and writes. ``mp >
1`` raises (the regressor has no tensor-parallel rules), as does a ``dp``
that does not divide the batch. Without a process group ``mesh: {dp: -1 |
1}`` (the shipped recipes) is this device, and a larger ``dp`` raises.
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from ..api import resolve_device
from ..data.dataset import _zero_mean_unit_var
from ..data.synthetic import synth_utterance
from ..io.checkpoint import load_state_dict, save_tree_npz
from ..models.hubert import HubertModel, matmul_precision
from ..ops.pitch import segment_pitch_cond
from ..ops.segment import averaged_target_fill, segment_batch
from ..parallel.mesh import is_main, maybe_distributed_init, mesh_from_config, shard_batch
from ..synthesis import (SegmentSynthesis, SynthesisConfig, init_synthesis_train_state,
                         make_synthesis_optimizer, make_synthesis_train_step,
                         synthesis_config_from_dict)
from ..utils.metrics import pearson, per_utterance_pitch_modulation
from .loop import MetricLogger, _fetch

SR = 16000
FRAME = 320
BUFFER = 160  # zero samples at both ends (the dataset's collate)


def build_synthesis_corpus(n_utts: int, seconds: float = 5.0, seed: int = 0,
                           style: str = "v1") -> Dict[str, np.ndarray]:
    """(wav, art) pairs with analytic articulatory ground truth: wav (N, S +
    2 * BUFFER) zero mean and unit variance, art (N, S // FRAME, 14) at
    50 Hz (the padded HuBERT frame count). The JAX package's corpus, sample
    for sample."""
    n_samples = int(seconds * SR) // FRAME * FRAME
    rng = np.random.RandomState(seed)
    pad = np.zeros(BUFFER, np.float32)
    wavs, arts = [], []
    for _ in range(n_utts):
        wav, _segs, art = synth_utterance(rng, n_samples, return_art=True, style=style)
        wavs.append(np.concatenate([pad, _zero_mean_unit_var(wav), pad]))
        arts.append(art)
    return {"wav": np.stack(wavs), "art": np.stack(arts)}


def padded_batches(wavs: np.ndarray, batch: int):
    """``(chunk, n_real)`` over ``wavs``, the last chunk padded with silence
    (one shape a run, as JAX keeps one compiled program)."""
    for i in range(0, len(wavs), batch):
        chunk = wavs[i: i + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        yield chunk, batch - pad


@torch.no_grad()  # not inference mode: the training step's autograd takes these tensors
def precompute_features(hubert: HubertModel, wav: np.ndarray, norm_threshold: float,
                        merge_threshold: float, batch: int = 32, explicit_pitch: bool = False,
                        pitch_mean: float = 120.0):
    """The averaged and blanked hidden states of a corpus, (N, L, d) on the
    encoder's device: per batch of ``batch`` utterances (the last padded
    with silence, as JAX keeps one compiled shape) the encoder, the
    segmentation (``segment_batch``, TF32 off) and ``averaged_target_fill``.
    With ``explicit_pitch`` also ``(features, pitch_cond)``, the frame-filled
    per-segment mean log(F0 / ``pitch_mean``) (N, L)."""
    device = next(hubert.parameters()).device
    hubert.eval()
    outs, pcs = [], []
    for chunk, n in padded_batches(wav, batch):
        w = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device)
        hidden = hubert(w, None).float()
        with matmul_precision("highest"):
            res = segment_batch(hidden, norm_threshold, merge_threshold)
        outs.append(averaged_target_fill(hidden, res.segments, res.num_segments)[:n])
        if explicit_pitch:
            pcs.append(segment_pitch_cond(w, res.segments, res.num_segments, hidden.shape[1],
                                          pitch_mean=pitch_mean)[:n])
    feats = torch.cat(outs)
    return (feats, torch.cat(pcs)) if explicit_pitch else feats


def score_art(art: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    """Sampled trajectories against the analytic ground truth, both cut to
    their common length: the per-utterance mean-removed pitch correlation,
    Pearson correlation of the log-pitch channel over voiced frames (truth
    loudness above 0.02) and of loudness over all frames, and the masked L1
    of the articulatory, pitch and loudness channels."""
    truth = np.asarray(truth, np.float32)
    L = min(art.shape[1], truth.shape[1])
    art, truth = art[:, :L], truth[:, :L]
    voiced = truth[..., 13] > 0.02
    return {"pitch_mod_r": per_utterance_pitch_modulation(art, truth),
            "pitch_corr": pearson(art[..., 12][voiced], truth[..., 12][voiced]),
            "loud_corr": pearson(art[..., 13].ravel(), truth[..., 13].ravel()),
            "art_l1_voiced": float(np.abs(art[..., :12][voiced] - truth[..., :12][voiced]).mean()),
            "pitch_l1_voiced": float(np.abs(art[..., 12][voiced] - truth[..., 12][voiced]).mean()),
            "loud_l1": float(np.abs(art[..., 13] - truth[..., 13]).mean())}


def evaluate_synthesis(synth: SegmentSynthesis, features, art_truth: np.ndarray,
                       steps: int = 50, seed: int = 0, method: str = "midpoint",
                       pitch_cond=None) -> Dict[str, float]:
    """Sample trajectories from the features and score them against the
    analytic ground truth (:func:`score_art`)."""
    art, _ = synth.resynthesize(features=features, steps=steps, seed=seed, method=method,
                                pitch_cond=pitch_cond)
    return {**score_art(art, art_truth), "n_eval_utts": int(art_truth.shape[0]),
            "ode_steps": steps}


def eval_chain(synth: SegmentSynthesis, norm_thr: float, merge_thr: float,
               heldout: Dict[str, np.ndarray], steps: int = 50, seed: int = 0,
               batch: int = 8) -> Tuple[np.ndarray, Dict[str, float]]:
    """The chain from the wav: ``synth.resynthesize(input_values=...)`` over
    :func:`padded_batches` of ``batch`` held-out utterances, so the
    segmentation, the quantizer (if ``synth`` has one) and the fill run on
    the device: ``(art, the :func:`score_art` metrics)``
    (``scripts/token_chain_proof.py``'s ``eval_chain``)."""
    arts = []
    for chunk, n in padded_batches(heldout["wav"], batch):
        art, _ = synth.resynthesize(input_values=chunk, steps=steps, seed=seed,
                                    normthreshold=norm_thr, merge_threshold=merge_thr)
        arts.append(art[:n])
    art = np.concatenate(arts, axis=0)
    return art, score_art(art, heldout["art"])


def check_mesh(cfg: Dict[str, Any]) -> None:
    """``mesh: {mp: 1}``: the synthesis trainers shard over dp only."""
    mesh = dict(cfg.get("mesh", {}) or {})
    if int(mesh.get("mp", 1)) != 1:
        raise ValueError("the synthesis trainers shard over dp only (mp must be 1)")


def synthesis_mesh(cfg: Dict[str, Any], device, batch_size: int):
    """The recipe's dp mesh over the process group (None for one process
    alone); raises where ``dp`` does not divide ``batch_size``."""
    check_mesh(cfg)
    mesh = mesh_from_config(cfg.get("mesh"), device)
    if mesh is not None:
        if batch_size % mesh.dp:
            raise ValueError(f"mesh dp={mesh.dp} does not divide the batch of {batch_size}")
        if is_main():
            print(f"mesh: dp={mesh.dp} over {dist.get_world_size()} ranks "
                  f"({dist.get_backend()})")
    return mesh


def setup(cfg: Dict[str, Any], seed: int, device, quantizer=None):
    """The pieces both trainers share: ``(model block, SynthesisConfig,
    SegmentSynthesis, norm threshold, merge threshold)``, the encoder from
    ``speech_model_ckpt`` (random, with a warning, without one)."""
    check_mesh(cfg)
    model_cfg = dict(cfg.get("model", cfg))
    sc = synthesis_config_from_dict(model_cfg)
    synth = SegmentSynthesis(config=sc, thresholder_configs=model_cfg.get("thresholder_configs"),
                             quantizer=quantizer, seed=seed, device=device)
    enc_ckpt = cfg.get("speech_model_ckpt")
    if enc_ckpt:
        sd = load_state_dict(enc_ckpt, sc.hubert.num_hidden_layers)
        missing = synth.hubert.load_state_dict(sd, strict=False).missing_keys
        if missing:
            raise KeyError(f"{enc_ckpt} lacks {missing}")
    else:
        import warnings

        warnings.warn("train_synthesis: no speech_model_ckpt; the conditioning features come "
                      "from a RANDOM-INIT encoder", stacklevel=2)
    norm_thr = model_cfg.get("norm_threshold")
    if norm_thr is None:
        norm_thr = synth.default_normthreshold
    lo, hi = sc.merge_threshold_range
    return model_cfg, sc, synth, float(norm_thr), (lo + hi) / 2.0


def corpus_features(synth: SegmentSynthesis, sc: SynthesisConfig, corpus, norm_thr, merge_thr):
    """(features, pitch_cond or None) of a corpus, on the device."""
    if sc.explicit_pitch_cond:
        return precompute_features(synth.hubert, corpus["wav"], norm_thr, merge_thr,
                                   explicit_pitch=True, pitch_mean=sc.pitch_cond_mean)
    return precompute_features(synth.hubert, corpus["wav"], norm_thr, merge_thr), None


def batch_order(n_utts: int, batch_size: int, seed: int):
    """The utterance indices of each step, as JAX's loop draws them: a new
    ``RandomState(seed + 1)`` shuffle whenever fewer than a batch are left."""
    rng = np.random.RandomState(seed + 1)
    order = np.array([], np.int64)
    while True:
        if len(order) < batch_size:
            order = np.arange(n_utts)
            rng.shuffle(order)
        idx, order = order[:batch_size], order[batch_size:]
        yield idx


def run_steps(step_fn, state, gather, n_utts: int, batch_size: int, total_steps: int,
              seed: int, log_every: int, logger: Optional[MetricLogger], device,
              mesh=None) -> None:
    """The step loop both trainers share: batches gathered on the device by
    index (under ``mesh`` this rank's rows of them), the metrics read every
    ``log_every`` steps (logged where ``logger`` is given), ``gc.collect()``
    every 50."""
    if n_utts < batch_size:
        raise ValueError(f"{n_utts} utterances for a batch of {batch_size}")
    t_last, s_last = time.perf_counter(), 0
    order = batch_order(n_utts, batch_size, seed)
    for step_i in range(total_steps):
        idx = torch.from_numpy(next(order)).to(device)
        metrics = step_fn(state, shard_batch(gather(idx), mesh), seed)
        if (step_i + 1) % log_every == 0:
            m = _fetch(metrics)
            now = time.perf_counter()
            m["steps_per_sec"] = (step_i + 1 - s_last) / max(now - t_last, 1e-9)
            t_last, s_last = now, step_i + 1
            if logger is None:
                continue
            row = logger.log(step_i + 1, m)
            print(f"step {step_i + 1}: " + " ".join(
                f"{k}={v:.4g}" for k, v in row.items() if k not in ("time", "prefix")),
                flush=True)
        if (step_i + 1) % 50 == 0:
            gc.collect()  # few but large objects: the collector lags without it


def train_synthesis(cfg: Dict[str, Any], out_dir: str = "runs/synthesis",
                    max_steps: Optional[int] = None, log_every: int = 50, seed: int = 0,
                    eval_steps: int = 50, device=None) -> Tuple[Any, Dict[str, float]]:
    """Train from the resynthesis recipe ``cfg`` (``model``, ``data``,
    ``train``, ``eval``, ``mesh`` sections) on ``device`` (``cuda`` unless
    the caller asks for the CPU); returns ``(SynthesisTrainState, eval
    metrics)``. The trained weights are ``synthesis_final.npz`` in
    ``out_dir`` and in ``state.synth``'s modules. Under a mesh the eval
    metrics are rank 0's (empty on the other ranks)."""
    maybe_distributed_init(cfg.get("distributed"), device)
    device = resolve_device(device)
    data_cfg, train_cfg = dict(cfg.get("data", {})), dict(cfg.get("train", {}))
    batch_size = train_cfg.get("batch_size", 32)
    mesh = synthesis_mesh(cfg, device, batch_size)
    model_cfg, sc, synth, norm_thr, merge_thr = setup(cfg, seed, device)
    if not data_cfg.get("synthetic", True):
        raise ValueError("only the synthetic (wav, art) corpus is available offline")
    n_utts, seconds = data_cfg.get("n_utts", 256), data_cfg.get("seconds", 5.0)
    style = data_cfg.get("style", "v1")
    corpus = build_synthesis_corpus(n_utts, seconds, seed=seed, style=style)
    t0 = time.time()
    features, pitch_cond = corpus_features(synth, sc, corpus, norm_thr, merge_thr)
    art = torch.from_numpy(corpus["art"]).to(device)
    print(f"precomputed features {tuple(features.shape)} (norm_thr {norm_thr:.3f}"
          f"{', explicit pitch cond' if pitch_cond is not None else ''}) in "
          f"{time.time() - t0:.1f}s")

    total_steps = max_steps or train_cfg.get("max_steps", 20_000)
    optimizer = make_synthesis_optimizer(lr=train_cfg.get("lr", 1e-4),
                                         warmup_steps=train_cfg.get("warmup_steps", 500),
                                         total_steps=total_steps,
                                         min_factor=train_cfg.get("min_factor", 0.05))
    state = init_synthesis_train_state(synth, optimizer)
    step_fn = make_synthesis_train_step(synth, optimizer, mesh=mesh)

    def gather(idx):
        batch = {"features": features[idx], "art": art[idx]}
        if pitch_cond is not None:
            batch["pitch_cond"] = pitch_cond[idx]
        return batch

    logger = MetricLogger(out_dir) if is_main() else None
    run_steps(step_fn, state, gather, n_utts, batch_size, total_steps, seed, log_every, logger,
              device, mesh)
    del features, art, pitch_cond
    if not is_main():
        dist.barrier()  # rank 0 evaluates and writes
        return state, {}

    n_eval = dict(cfg.get("eval", {})).get("n_utts", 24)
    heldout = build_synthesis_corpus(n_eval, seconds, seed=seed + 90001, style=style)
    feats_ev, pitch_ev = corpus_features(synth, sc, heldout, norm_thr, merge_thr)
    metrics = evaluate_synthesis(synth, feats_ev, heldout["art"], steps=eval_steps, seed=seed,
                                 pitch_cond=pitch_ev)
    logger.log(total_steps, metrics, prefix="eval")
    print("eval:", json.dumps(metrics))
    save_tree_npz(os.path.join(out_dir, "synthesis_final.npz"), synth.jax_tree())
    with open(os.path.join(out_dir, "eval.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    if mesh is not None:
        dist.barrier()
    return state, metrics
