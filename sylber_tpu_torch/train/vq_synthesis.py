"""Joint training of the grouped-residual-VQ quantizer with the CFM
resynthesis model.

Port of ``sylber_tpu/train/vq_synthesis.py``: the (averaged, blanked)
conditioning features go through the quantizer's encoder, are unit-normed,
blank frames kept zero, and quantized per art / pitch sub-space
(straight-through); the input MLP and the regressor learn the CFM loss from
the quantized embedding, a commitment loss pulls the encoder's outputs
toward their codes, and an optional linear head on the quantized pitch
sub-space predicts the frame's log-pitch (times ``pitch_amp``) over voiced
frames. After the optimizer step both codebooks take the EMA k-means update
(``flow/quantizer.py::vq_ema_update``) from the step's pre-VQ outputs, with
the blank frames masked out and dead codes reseeded.

Randomness (intended difference (aa), ``ROADMAP.md`` section 3): the CFM's
draws and the reseeding's come from ``train/distill.py::step_generators``
(the reseed draws after the CFM's, on the span-mask generator); the tests
pass JAX's in (``draws=``, ``sample_idx=``).

The trained state loads into ``vq_tokenizer.py::TrainedVQTokenizer`` and,
through its ``save_npz``, into the JAX package's ``TrainedVQTokenizer.load_npz``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import resolve_device
from ..flow.cfm import CFMDraws, cfm_draws
from ..flow.quantizer import (QuantizerConfig, QuantizerState, quantizer_forward,
                              quantizer_init, quantizer_to, vq_ema_update, vq_reseed_draw)
from ..io.checkpoint import save_tree_npz, tree_from_state_dict
from ..synthesis import (InputMLP, SegmentSynthesis, SynthesisOptimizer,
                         make_synthesis_optimizer, train_update)
from ..utils.metrics import pearson
from ..vq_tokenizer import TrainedVQTokenizer, quantizer_config_from_dict
from .distill import make_optimizer, step_generators
from .loop import MetricLogger

__all__ = ["VQSynthState", "quantizer_config_from_dict", "make_vq_synthesis_train_step",
           "init_vq_synthesis_train_state", "train_vq_synthesis"]


@dataclasses.dataclass
class VQSynthState:
    step: int                         # updates taken, a host count
    quantizer: QuantizerState         # the encoder's leaves are trained, the VQs by EMA
    pitch_head: Dict[str, torch.Tensor]  # {"kernel": (pitch_emb_dim,), "bias": ()}
    params: List[torch.Tensor]        # encoder, input MLP, regressor, pitch head
    optimizer: torch.optim.AdamW
    synth: SegmentSynthesis           # its input MLP and regressor are trained in place


def init_vq_synthesis_train_state(synth: SegmentSynthesis, qcfg: QuantizerConfig,
                                  optimizer: SynthesisOptimizer, seed: int = 0,
                                  quantizer: Optional[QuantizerState] = None) -> VQSynthState:
    """A fresh quantizer (Glorot encoder, normal(0, 0.02) codebooks), a
    fresh input MLP on the quantizer's output width, a zero pitch head; the
    regressor is the synth's. With ``quantizer`` (a trained state) training
    continues from it and from the synth's input MLP as they are. The
    speech encoder is frozen."""
    device = synth.device
    if quantizer is None:
        g = torch.Generator().manual_seed(int(seed))
        quantizer = quantizer_init(qcfg, g, device)
        c = synth.config
        mlp = InputMLP(qcfg.output_dim, c.input_output_dim, c.input_hidden_dims, c.input_dropout)
        for m in mlp.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.data.normal_(0.0, m.weight.shape[1] ** -0.5, generator=g)
                m.bias.data.zero_()
        synth.input_mlp = mlp.to(device).eval()
    else:
        quantizer = quantizer_to(quantizer, device)
    synth.hubert.requires_grad_(False)
    head = {"kernel": torch.zeros(qcfg.pitch_emb_dim, device=device),
            "bias": torch.zeros((), device=device)}
    params = [t for layer in quantizer.encoder for t in layer.values()]
    params += [p for m in synth.trainable_modules() for p in m.parameters()]
    params += [head["kernel"], head["bias"]]
    for p in params:
        p.requires_grad_(True)
    return VQSynthState(0, quantizer, head, params, make_optimizer(optimizer, params), synth)


def make_vq_synthesis_train_step(synth: SegmentSynthesis, qcfg: QuantizerConfig,
                                 optimizer: SynthesisOptimizer, commit_weight: float = 1.0,
                                 pitch_weight: float = 0.0):
    """Returns ``(state, batch, seed, draws=None, sample_idx=None) ->
    metrics``: one update in place. ``batch``: ``features`` (B, L, d),
    ``art`` (B, L, 14), optional ``mask``. ``sample_idx``: the reseed draws
    of the art and the pitch VQ (each (groups, quantizers, K)), else drawn.
    The metrics (``loss``, ``cfm_loss``, ``commit_loss``, ``pitch_loss``,
    ``grad_norm``) are device tensors; nothing is read back."""
    c = synth.config
    schedule = optimizer.schedule()
    n_art = qcfg.art_vq.groups * qcfg.art_vq.num_quantizers
    P = qcfg.pitch_emb_dim

    def train_step(state: VQSynthState, batch: Dict[str, torch.Tensor], seed: int,
                   draws: Optional[CFMDraws] = None,
                   sample_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        device = state.params[0].device
        feats = batch["features"]
        non_blank = (feats ** 2).sum(-1) > 0
        gens = step_generators(seed, state.step, device)
        if draws is None:
            draws = cfm_draws(batch["art"].shape, gens.noise, gens.mask, gens.drop, device)
        out = {}

        def loss_fn():
            out.update(quantizer_forward(state.quantizer, qcfg, feats))
            quantized = torch.where(non_blank[..., None], out["quantize"], 0.0)
            cfm = synth.loss(batch, draws, cond_fn=lambda drop: torch.where(
                non_blank[..., None], synth.input_mlp(quantized, drop), 0.0))
            head = state.pitch_head
            pred = out["quantize"][..., -P:] @ head["kernel"] + head["bias"]
            voiced = batch["art"][..., 13] > 0.02
            pmask = (non_blank & voiced).float()
            perr = (pred - batch["art"][..., 12] * c.pitch_amp) ** 2
            pitch_loss = (perr * pmask).sum() / torch.clamp_min(pmask.sum(), 1.0)
            commit = out["commitment_loss"]
            total = cfm + commit_weight * commit + pitch_weight * pitch_loss
            return total, {"cfm_loss": cfm.detach(), "commit_loss": commit.detach(),
                           "pitch_loss": pitch_loss.detach()}

        total, aux, grad_norm = train_update(synth, state, optimizer, schedule, loss_fn)

        # the codebooks' EMA update from the pre-VQ outputs (the
        # straight-through path never updates them), blanks masked out
        pre, idx = out["non_quantized"].detach(), out["indices"]
        q = state.quantizer
        if sample_idx is None:
            m = non_blank.reshape(-1).float()
            sample_idx = tuple(
                vq_reseed_draw(gens.mask, m, (v.groups, v.num_quantizers, v.codebook_size))
                for v in (qcfg.art_vq, qcfg.pitch_vq))
        art_vq = vq_ema_update(q.art_vq, qcfg.art_vq, pre[..., :-P], idx[..., :n_art],
                               mask=non_blank, sample_idx=sample_idx[0])
        pitch_vq = vq_ema_update(q.pitch_vq, qcfg.pitch_vq, pre[..., -P:], idx[..., n_art:],
                                 mask=non_blank, sample_idx=sample_idx[1])
        state.quantizer = QuantizerState(q.encoder, art_vq, pitch_vq)
        state.step += 1
        return {"loss": total.detach(), **aux, "grad_norm": grad_norm}

    return train_step


def tokenizer_of(state: VQSynthState, qcfg: QuantizerConfig) -> TrainedVQTokenizer:
    """The trained quantizer as a tokenizer (detached copies, same device)."""
    q = state.quantizer
    enc = [{k: v.detach().clone() for k, v in layer.items()} for layer in q.encoder]
    return TrainedVQTokenizer(QuantizerState(enc, q.art_vq, q.pitch_vq), qcfg,
                              device=state.synth.device)


def _eval_token_chain(synth: SegmentSynthesis, norm_thr: float, merge_thr: float,
                      heldout: Dict[str, np.ndarray], steps: int = 50, seed: int = 0,
                      batch: int = 8) -> Dict[str, float]:
    """The wav -> tokens -> CFM chain (``synth.quantizer`` set) scored as
    ``evaluate_synthesis`` scores: pitch and loudness correlation and masked
    L1 against the analytic truth, over batches of ``batch`` utterances."""
    wavs, truth = heldout["wav"], np.asarray(heldout["art"], np.float32)
    arts = []
    for i in range(0, len(wavs), batch):
        chunk = wavs[i: i + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        a, _ = synth.resynthesize(input_values=chunk, steps=steps, seed=seed,
                                  normthreshold=norm_thr, merge_threshold=merge_thr)
        arts.append(a[: batch - pad])
    a = np.concatenate(arts, axis=0)
    L = min(a.shape[1], truth.shape[1])
    a, tr = a[:, :L], truth[:, :L]
    voiced = tr[..., 13] > 0.02
    return {"pitch_corr": pearson(a[..., 12][voiced], tr[..., 12][voiced]),
            "loud_corr": pearson(a[..., 13].ravel(), tr[..., 13].ravel()),
            "art_l1_voiced": float(np.abs(a[..., :12][voiced] - tr[..., :12][voiced]).mean()),
            "pitch_l1_voiced": float(np.abs(a[..., 12][voiced] - tr[..., 12][voiced]).mean()),
            "loud_l1": float(np.abs(a[..., 13] - tr[..., 13]).mean()),
            "ode_steps": steps, "n_eval_utts": int(tr.shape[0])}


def train_vq_synthesis(cfg: Dict[str, Any], out_dir: str = "runs/vq_synth",
                       max_steps: Optional[int] = None, log_every: int = 50, seed: int = 0,
                       eval_steps: int = 50, device=None):
    """Train the quantizer, input MLP and regressor jointly from a recipe
    with a ``model.quantizer_configs`` block; returns ``(VQSynthState,
    QuantizerConfig, eval metrics of the wav -> tokens -> CFM chain)``.
    Writes ``vq_synthesis_final.npz`` (``input_mlp``, ``regressor``),
    ``vq_tokenizer.npz``, ``eval.json`` and ``metrics.jsonl``."""
    from .synthesis_loop import build_synthesis_corpus, corpus_features, run_steps, setup

    device = resolve_device(device)
    if not cfg.get("speech_model_ckpt"):
        raise ValueError("train_vq_synthesis needs a trained encoder (speech_model_ckpt)")
    data_cfg, train_cfg = dict(cfg.get("data", {})), dict(cfg.get("train", {}))
    model_cfg, sc, synth, norm_thr, merge_thr = setup(cfg, seed, device)
    qcfg = quantizer_config_from_dict(model_cfg.get("quantizer_configs"),
                                      input_dim=sc.hubert.hidden_size)
    n_utts, seconds = data_cfg.get("n_utts", 256), data_cfg.get("seconds", 5.0)
    style = data_cfg.get("style", "v1")
    corpus = build_synthesis_corpus(n_utts, seconds, seed=seed, style=style)
    t0 = time.time()
    features, _ = corpus_features(synth, dataclasses.replace(sc, explicit_pitch_cond=False),
                                  corpus, norm_thr, merge_thr)
    art = torch.from_numpy(corpus["art"]).to(device)
    print(f"precomputed features {tuple(features.shape)} in {time.time() - t0:.1f}s")

    total_steps = max_steps or train_cfg.get("max_steps", 20_000)
    optimizer = make_synthesis_optimizer(lr=train_cfg.get("lr", 1e-4),
                                         warmup_steps=train_cfg.get("warmup_steps", 500),
                                         total_steps=total_steps,
                                         min_factor=train_cfg.get("min_factor", 0.05))
    state = init_vq_synthesis_train_state(synth, qcfg, optimizer, seed=seed + 7)
    step_fn = make_vq_synthesis_train_step(
        synth, qcfg, optimizer, commit_weight=float(train_cfg.get("commit_weight", 1.0)),
        pitch_weight=float(train_cfg.get("pitch_loss_weight", 0.0)))
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricLogger(out_dir)
    run_steps(step_fn, state, lambda idx: {"features": features[idx], "art": art[idx]}, n_utts,
              train_cfg.get("batch_size", 32), total_steps, seed, log_every, logger, device)
    del features, art

    tok = tokenizer_of(state, qcfg)
    synth.quantizer = tok
    n_eval = dict(cfg.get("eval", {})).get("n_utts", 24)
    heldout = build_synthesis_corpus(n_eval, seconds, seed=seed + 90001, style=style)
    metrics = _eval_token_chain(synth, norm_thr, merge_thr, heldout, steps=eval_steps, seed=seed)
    logger.log(total_steps, metrics, prefix="eval")
    print("eval:", json.dumps(metrics))
    tok.save_npz(os.path.join(out_dir, "vq_tokenizer.npz"))
    save_tree_npz(os.path.join(out_dir, "vq_synthesis_final.npz"),
                  {"input_mlp": tree_from_state_dict(synth.input_mlp.state_dict()),
                   "regressor": tree_from_state_dict(synth.regressor.state_dict())})
    with open(os.path.join(out_dir, "eval.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    return state, qcfg, metrics
