"""End-to-end training proof on synthetic speech with known boundaries.

Port of ``scripts/train_mini_proof.py``. Trains a small but architecturally
complete Sylber (9-layer HuBERT, 144 wide) through stage 1 and then stage 2
of the distillation (``train/loop.py::train``) on the synthetic syllabic
corpus (``data/synthetic.py``), then evaluates on held-out audio:

- boundary F1 of the learned segmentation against the analytic truth;
- the token rate beside the truth's (the reference reports 4.27 on
  LibriSpeech);
- the fast mode (bf16 everywhere, "default" precision) against the exact
  mode (fp32, "highest"): the segmentation's agreement.

Writes ``<out-dir>/mini_ckpt.npz`` (the stage-2 student, JAX layout, which
both packages' ``Segmenter`` read) and ``<out-dir>/mini_ckpt.json`` (the
keys of ``tests/fixtures/mini_ckpt.json``: config, learned threshold, eval).
The recipe of ``tests/fixtures/mini_ckpt.json``:

    python -m sylber_tpu_torch.mini_proof --stage1-steps 4000 \\
        --stage2-steps 1500 --batch-size 32 --n-utts 384

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. One step runs a dispatch: the port has no ``steps_per_dispatch``
(the flag is read and ignored); a step's math is the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

MINI_HUBERT = {
    "hidden_size": 144,
    "num_attention_heads": 12,
    "intermediate_size": 576,
    "conv_dim": [128] * 7,
    "num_conv_pos_embeddings": 64,
    "num_conv_pos_embedding_groups": 16,
}


def _model_cfg(stage2: bool, thr: Optional[dict], lr: float, steps: int,
               hub_dict: Optional[dict] = None) -> Dict[str, Any]:
    m = {
        "encoding_layer": 9,
        "ema_decay": 1.0,
        "hubert": dict(MINI_HUBERT if hub_dict is None else hub_dict),
        "precision": "default",
        "lr": lr,
        "warmup_steps": 100,
        "total_steps": steps,
        "min_factor": 1.0,
        "do_noise_augment": True,
        "noise_mixer_configs": {"augment_prob": 0.2, "utterance_mix_ratio": 0.25},
        "mask_prob": 0.0,
    }
    if stage2:
        m.update(segment_online=True, merge_threshold_range=[0.8, 0.9],
                 use_train_thrupdate=True, thresholder_configs=thr or {})
    return m


def _data_cfg(n_utts: int, stage2: bool, batch_size: int, style: str = "v1") -> Dict[str, Any]:
    return {"synthetic": True, "n_utts": n_utts, "max_len": 80_000,
            "batch_size": batch_size, "segment_online_data": stage2, "style": style}


def hubert_config(hub_dict: Dict[str, Any]):
    """The proof's encoder: 9 layers at ``hub_dict``'s widths, "default"
    precision."""
    from .models.hubert import HubertConfig

    return HubertConfig(num_hidden_layers=9, precision="default",
                        **{k: tuple(v) if isinstance(v, list) else v
                           for k, v in hub_dict.items()})


def measure_norm_stats(params, hubert_config, seed=123, n_utts=8, style="v1",
                       device=None) -> Dict[str, float]:
    """The frame norms' mean and variance over voiced and silent frames (the
    synthetic truth) of ``params`` (a JAX-layout tree), which start the
    stage-2 thresholder at this model's norm scale."""
    import torch

    from .api import resolve_device
    from .data.synthetic import synth_utterance
    from .io.checkpoint import state_dict_from_jax_params
    from .models.hubert import HubertModel

    device = resolve_device(device)
    model = HubertModel(hubert_config)
    model.load_state_dict(state_dict_from_jax_params(params))
    model = model.to(device).eval()
    rng = np.random.RandomState(seed)
    sig, noi = [], []
    for _ in range(n_utts):
        wav, segs = synth_utterance(rng, 5 * 16000, style=style)
        w = ((wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)).astype(np.float32)
        with torch.inference_mode():
            h = model(torch.from_numpy(w[None]).to(device), None).float().cpu().numpy()
        norms = np.sqrt((h[0].astype(np.float64) ** 2).sum(-1) + 1e-8)
        m = np.zeros(len(norms), bool)
        for s, e in segs:
            m[s:min(e, len(norms))] = True
        sig.append(norms[m])
        noi.append(norms[~m])
    sig, noi = np.concatenate(sig), np.concatenate(noi)
    return {"signal_mean": float(sig.mean()), "signal_var": float(sig.var()),
            "noise_mean": float(noi.mean()), "noise_var": float(noi.var())}


def held_out(n_utts: int = 24, seed: int = 7777, style: str = "v1"):
    """The held-out utterances (3-8 s, normalised) and their true segments."""
    from .data.synthetic import synth_utterance

    rng = np.random.RandomState(seed)
    wavs, truths = [], []
    for _ in range(n_utts):
        n = int(rng.uniform(3.0, 8.0) * 16000)
        wav, segs = synth_utterance(rng, n, style=style)
        wavs.append(((wav - wav.mean()) / (wav.std(ddof=1) + 1e-12)).astype(np.float32))
        truths.append(segs)
    return wavs, truths


def evaluate(params, hubert_config, norm_threshold, merge_threshold=0.8, n_utts=24,
             seed=7777, style="v1", device=None) -> Dict[str, Any]:
    """Held-out eval of ``params`` (a JAX-layout tree): boundary F1 against
    the truth, and the fast mode against the exact mode."""
    from .api import Segmenter
    from .utils.metrics import boundary_f1, token_rate

    wavs, truths = held_out(n_utts, seed, style)

    def seg_for(dtype, precision):
        cfg = dataclasses.replace(hubert_config, dtype=dtype, frontend_dtype=dtype,
                                  precision=precision)
        return Segmenter(params=params, hubert_config=cfg, norm_threshold=norm_threshold,
                         merge_threshold=merge_threshold, device=device)

    out_e = seg_for("float32", "highest").process(wavs, in_second=False, return_hidden=False)
    out_f = seg_for("bfloat16", "default").process(wavs, in_second=False, return_hidden=False)

    def mean_f1(pairs, tol):
        return float(np.mean([boundary_f1(a, b, tol_frames=tol) for a, b in pairs]))

    vs_truth = [(o["segments"], t) for o, t in zip(out_e, truths)]
    fast_exact = [(f["segments"], e["segments"]) for f, e in zip(out_f, out_e)]
    secs = [len(w) / 16000.0 for w in wavs]
    return {
        "boundary_f1_vs_truth_tol1": mean_f1(vs_truth, 1),
        "boundary_f1_vs_truth_tol2": mean_f1(vs_truth, 2),
        "fast_vs_exact_boundary_f1_tol0": mean_f1(fast_exact, 0),
        "fast_vs_exact_boundary_f1_tol1": mean_f1(fast_exact, 1),
        "fast_vs_exact_nseg_delta_mean": float(np.mean([abs(len(f) - len(e))
                                                        for f, e in fast_exact])),
        "token_rate_exact": token_rate([o["segments"] for o in out_e], secs),
        "token_rate_truth": token_rate(truths, secs),
        "n_eval_utts": n_utts,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="runs/mini_proof_torch")
    ap.add_argument("--stage1-steps", type=int, default=1500)
    ap.add_argument("--stage2-steps", type=int, default=600)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--n-utts", type=int, default=256)
    ap.add_argument("--steps-per-dispatch", type=int, default=8,
                    help="read for the JAX script's flags and ignored: one step runs a "
                         "dispatch here, with the same math")
    ap.add_argument("--style", default="v1", choices=["v1", "rich"],
                    help="synthetic corpus style (rich: multi-speaker + phrase "
                         "intonation); the output's name gains a _rich suffix")
    ap.add_argument("--full", action="store_true",
                    help="full-width 768-d HuBERT base instead of the 144-d mini; the "
                         "output is named full_ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Train, evaluate and write the checkpoint; return the ``.json``'s
    contents with the stages' wall times (``"timing"``, not written)."""
    args = parse_args(argv)
    import torch

    from .api import resolve_device
    from .io.checkpoint import (jax_params_from_state_dict, load_params_npz, save_params_npz,
                                state_dict_from_jax_params)
    from .train.loop import train
    from .train.thresholder import get_threshold

    device = resolve_device(args.device)
    hub_dict = {} if args.full else MINI_HUBERT
    name = ("full_ckpt" if args.full else "mini_ckpt") + (
        f"_{args.style}" if args.style != "v1" else "")
    print(f"device: {device}"
          + (f" {torch.cuda.get_device_name(device)}" if device.type == "cuda" else "")
          + "; one step a dispatch")

    # ---- stage 1: distil onto the ground-truth segments ----
    cfg1 = {"name": "mini_stage1", "seed": 0,
            "model": _model_cfg(False, None, lr=2e-4 if args.full else 5e-4,
                                steps=args.stage1_steps, hub_dict=hub_dict),
            "data": _data_cfg(args.n_utts, False, args.batch_size, style=args.style),
            "max_steps": args.stage1_steps}
    out1 = os.path.join(args.out_dir, "stage1")
    t0 = time.perf_counter()
    train(cfg1, out_dir=out1, max_steps=args.stage1_steps, log_every=100,
          ckpt_every=args.stage1_steps, device=device)
    stage1_s = time.perf_counter() - t0
    params1 = load_params_npz(os.path.join(out1, "params_final.npz"))

    hub = hubert_config(hub_dict)
    thr_stats = measure_norm_stats(params1, hub, style=args.style, device=device)
    print("measured norm stats:", json.dumps(thr_stats))

    # ---- stage 2: online segmentation ----
    cfg2 = {"name": "mini_stage2", "seed": 1,
            "model": _model_cfg(True, thr_stats, lr=1e-4 if args.full else 2e-4,
                                steps=args.stage2_steps, hub_dict=hub_dict),
            "data": _data_cfg(args.n_utts, True, args.batch_size, style=args.style),
            "max_steps": args.stage2_steps}
    out2 = os.path.join(args.out_dir, "stage2")
    t0 = time.perf_counter()
    state = train(cfg2, out_dir=out2, max_steps=args.stage2_steps, log_every=100,
                  ckpt_every=args.stage2_steps, init_params=state_dict_from_jax_params(params1),
                  device=device)
    stage2_s = time.perf_counter() - t0
    sd2 = state.student.state_dict()
    params2 = jax_params_from_state_dict(sd2)
    learned_thr = float(get_threshold(state.thresholder))
    print(f"learned norm threshold: {learned_thr:.4f}")

    # ---- held-out evaluation ----
    t0 = time.perf_counter()
    results = evaluate(params2, hub, learned_thr, style=args.style, device=device)
    eval_s = time.perf_counter() - t0
    print(json.dumps(results, indent=2))

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_params_npz(str(out / f"{name}.npz"), sd2)
    meta = {"hubert": hub_dict, "encoding_layer": 9, "norm_threshold": learned_thr,
            "merge_threshold": 0.8, "thresholder_stats": thr_stats,
            "train": {"stage1_steps": args.stage1_steps, "stage2_steps": args.stage2_steps,
                      "batch_size": args.batch_size, "n_utts": args.n_utts},
            "eval": results}
    (out / f"{name}.json").write_text(json.dumps(meta, indent=2))
    print(f"written: {out / name}.npz, {out / name}.json")
    return dict(meta, timing={"stage1_s": stage1_s, "stage2_s": stage2_s, "eval_s": eval_s})


if __name__ == "__main__":
    main()
