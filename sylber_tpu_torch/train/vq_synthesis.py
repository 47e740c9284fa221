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

Data parallelism (``mesh: {dp}``, as ``train/synthesis_loop.py`` takes it;
JAX's ``vq_synthesis.py:325-350``): each rank takes its rows of the global
batch, the draws are the global batch's (but dropout, seeded per rank), the
gradients are averaged over ``dp``; the pitch loss divides by the global
batch's voiced count; the codebooks' EMA counts and sums are all-reduced
and the dead codes reseeded from the global batch's points, so the ranks'
codebooks never drift apart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..api import resolve_device
from ..flow.cfm import CFMDraws
from ..flow.quantizer import (QuantizerConfig, QuantizerState, quantizer_forward,
                              quantizer_init, quantizer_to, vq_ema_update, vq_reseed_draw)
from ..io.checkpoint import save_tree_npz, tree_from_state_dict
from ..parallel.mesh import all_gather_cat, is_main, maybe_distributed_init, reduce_mean
from ..synthesis import (InputMLP, SegmentSynthesis, SynthesisOptimizer, global_cfm_draws,
                         make_synthesis_optimizer, train_update)
from ..vq_tokenizer import TrainedVQTokenizer, quantizer_config_from_dict
from .distill import make_optimizer, step_generators
from .loop import MetricLogger

__all__ = ["VQSynthState", "quantizer_config_from_dict", "make_vq_synthesis_train_step",
           "init_vq_synthesis_train_state", "train_vq_synthesis", "eval_gate_failures"]


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
                                 pitch_weight: float = 0.0, mesh=None):
    """Returns ``(state, batch, seed, draws=None, sample_idx=None) ->
    metrics``: one update in place. ``batch``: ``features`` (B, L, d),
    ``art`` (B, L, 14), optional ``mask``. ``sample_idx``: the reseed draws
    of the art and the pitch VQ (each (groups, quantizers, K)), else drawn.
    The metrics (``loss``, ``cfm_loss``, ``commit_loss``, ``pitch_loss``,
    ``grad_norm``) are device tensors; nothing is read back. Under ``mesh``
    ``batch`` is this rank's rows and the metrics are the global batch's."""
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
        gens = step_generators(seed, state.step, device, rank=mesh.dp_rank if mesh else 0)
        if draws is None:   # the reseed draws follow the CFM's on gens.mask
            draws = global_cfm_draws(batch["art"].shape, gens, device, mesh)
        group = None if mesh is None else mesh.group("dp")
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
            count = pmask.sum()
            if mesh is not None:   # the global batch's voiced frames; the mean
                count = count.detach().clone()   # of the ranks' gradients is then its
                dist.all_reduce(count, group=group)   # gradient
                pitch_loss = (perr * pmask).sum() * mesh.dp / torch.clamp_min(count, 1.0)
            else:
                pitch_loss = (perr * pmask).sum() / torch.clamp_min(count, 1.0)
            commit = out["commitment_loss"]
            total = cfm + commit_weight * commit + pitch_weight * pitch_loss
            return total, {"cfm_loss": cfm.detach(), "commit_loss": commit.detach(),
                           "pitch_loss": pitch_loss.detach()}

        total, aux, grad_norm = train_update(synth, state, optimizer, schedule, loss_fn, mesh)

        # the codebooks' EMA update from the pre-VQ outputs (the
        # straight-through path never updates them), blanks masked out
        pre, idx = out["non_quantized"].detach(), out["indices"]
        q = state.quantizer
        if sample_idx is None:
            m = non_blank.reshape(-1).float()
            if mesh is not None:   # the draw is over the global batch's points
                m = all_gather_cat(m, 0, group)
            sample_idx = tuple(
                vq_reseed_draw(gens.mask, m, (v.groups, v.num_quantizers, v.codebook_size))
                for v in (qcfg.art_vq, qcfg.pitch_vq))
        art_vq = vq_ema_update(q.art_vq, qcfg.art_vq, pre[..., :-P], idx[..., :n_art],
                               mask=non_blank, sample_idx=sample_idx[0], group=group)
        pitch_vq = vq_ema_update(q.pitch_vq, qcfg.pitch_vq, pre[..., -P:], idx[..., n_art:],
                                 mask=non_blank, sample_idx=sample_idx[1], group=group)
        state.quantizer = QuantizerState(q.encoder, art_vq, pitch_vq)
        state.step += 1
        metrics = reduce_mean({"loss": total.detach(), **aux}, mesh)
        return {**metrics, "grad_norm": grad_norm}

    return train_step


def tokenizer_of(state: VQSynthState, qcfg: QuantizerConfig) -> TrainedVQTokenizer:
    """The trained quantizer as a tokenizer (detached copies, same device)."""
    q = state.quantizer
    enc = [{k: v.detach().clone() for k, v in layer.items()} for layer in q.encoder]
    return TrainedVQTokenizer(QuantizerState(enc, q.art_vq, q.pitch_vq), qcfg,
                              device=state.synth.device)


def eval_gate_failures(ev: Dict[str, float], supervised: bool) -> List[str]:
    """The JAX package's gates on the joint VQ's held-out eval
    (``tests/parity/test_token_resynthesis.py:264-266``): loud_corr > 0.6,
    and pitch_corr > 0.5 where the recipe trains the pitch head
    (``train.pitch_loss_weight`` > 0). Returns the gates missed."""
    gates = [(f"loud_corr > 0.6 ({ev['loud_corr']})", ev["loud_corr"] > 0.6)]
    if supervised:
        gates.append((f"pitch_corr > 0.5 ({ev['pitch_corr']})", ev["pitch_corr"] > 0.5))
    return [name for name, ok in gates if not ok]


def train_vq_synthesis(cfg: Dict[str, Any], out_dir: str = "runs/vq_synth",
                       max_steps: Optional[int] = None, log_every: int = 50, seed: int = 0,
                       eval_steps: int = 50, device=None):
    """Train the quantizer, input MLP and regressor jointly from a recipe
    with a ``model.quantizer_configs`` block; returns ``(VQSynthState,
    QuantizerConfig, eval metrics of the wav -> tokens -> CFM chain)``.
    Writes ``vq_synthesis_final.npz`` (``input_mlp``, ``regressor``),
    ``vq_tokenizer.npz``, ``eval.json`` and ``metrics.jsonl`` (rank 0, whose
    eval metrics alone are returned under a mesh)."""
    from .synthesis_loop import (build_synthesis_corpus, corpus_features, eval_chain, run_steps,
                                 setup, synthesis_mesh)

    maybe_distributed_init(cfg.get("distributed"), device)
    device = resolve_device(device)
    if not cfg.get("speech_model_ckpt"):
        raise ValueError("train_vq_synthesis needs a trained encoder (speech_model_ckpt)")
    data_cfg, train_cfg = dict(cfg.get("data", {})), dict(cfg.get("train", {}))
    batch_size = train_cfg.get("batch_size", 32)
    mesh = synthesis_mesh(cfg, device, batch_size)
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
        pitch_weight=float(train_cfg.get("pitch_loss_weight", 0.0)), mesh=mesh)
    logger = MetricLogger(out_dir) if is_main() else None
    run_steps(step_fn, state, lambda idx: {"features": features[idx], "art": art[idx]}, n_utts,
              batch_size, total_steps, seed, log_every, logger, device, mesh)
    del features, art
    if not is_main():
        dist.barrier()  # rank 0 evaluates and writes
        return state, qcfg, {}

    tok = tokenizer_of(state, qcfg)
    synth.quantizer = tok
    n_eval = dict(cfg.get("eval", {})).get("n_utts", 24)
    heldout = build_synthesis_corpus(n_eval, seconds, seed=seed + 90001, style=style)
    _, metrics = eval_chain(synth, norm_thr, merge_thr, heldout, steps=eval_steps, seed=seed)
    metrics.update(ode_steps=eval_steps, n_eval_utts=int(len(heldout["wav"])))
    logger.log(total_steps, metrics, prefix="eval")
    print("eval:", json.dumps(metrics))
    tok.save_npz(os.path.join(out_dir, "vq_tokenizer.npz"))
    save_tree_npz(os.path.join(out_dir, "vq_synthesis_final.npz"),
                  {"input_mlp": tree_from_state_dict(synth.input_mlp.state_dict()),
                   "regressor": tree_from_state_dict(synth.regressor.state_dict())})
    with open(os.path.join(out_dir, "eval.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    if mesh is not None:
        dist.barrier()
    return state, qcfg, metrics
