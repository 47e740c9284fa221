"""Per-utterance pitch-modulation decodability ceiling of encoder features.

Port of ``scripts/pitch_decodability_probe.py``. The CFM resynthesis stack
is conditioned on segment-averaged encoder features, so whatever
per-utterance pitch modulation (the mean-removed contour) it can reproduce
is bounded by what is linearly decodable from those features. This probe
fits a float64 closed-form ridge regressor with a bias column, features ->
per-frame log-pitch over voiced frames, on the first half of a synthetic
corpus, and scores the per-utterance mean-removed Pearson r on the other
half (utterances with at least 20 voiced frames), with the pooled r over all
voiced frames beside it.

The encoder is a fixture's (``--encoder``: its meta JSON, the ``.npz``
beside it) at ``num_hidden_layers = encoding_layer`` and
``precision="default"``, as the JAX script builds it: on the card that
allows TF32 in its matmuls and convolutions, so the card's r differs from
the CPU's (full float32) by TF32 rounding. The features are
``train/synthesis_loop.py::precompute_features``'s (the segmentation kernels
and the averaged fill), 8 utterances a batch. Writes
``<out-dir>/pitch_decodability_probe.json``:

    python -m sylber_tpu_torch.pitch_decodability_probe \\
        [--encoder tests/fixtures/mini_ckpt_rich.json] [--style rich] [--n 56]
        [--out-dir runs/pitch_decodability_probe]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np


def per_utt_mean_removed_corr(pred, truth, voiced) -> Tuple[float, List[float]]:
    """Mean-removed (within-utterance) Pearson r, averaged over utts with
    enough voiced frames to define a contour."""
    rs = []
    for p, t, v in zip(pred, truth, voiced):
        if v.sum() < 20:
            continue
        a = p[v] - p[v].mean()
        b = t[v] - t[v].mean()
        den = np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12
        rs.append(float((a * b).sum() / den))
    return float(np.mean(rs)), rs


def load_encoder(meta_path: str, device):
    """The fixture's encoder: its meta's widths, ``encoding_layer`` layers,
    ``precision="default"``, the ``.npz`` weights; ``(model, meta)``."""
    from .io.checkpoint import load_state_dict
    from .models.hubert import HubertConfig, HubertModel
    from .segment_corpus import model_widths

    meta = json.loads(Path(meta_path).read_text())
    cfg = HubertConfig(precision="default", **model_widths(meta_path))
    model = HubertModel(cfg)
    model.load_state_dict(load_state_dict(str(Path(meta_path).with_suffix(".npz")),
                                          cfg.num_hidden_layers))
    return model.to(device).eval(), meta


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="tests/fixtures/mini_ckpt.json",
                    help="encoder fixture meta json (npz alongside)")
    ap.add_argument("--style", default="rich", choices=["v1", "rich"])
    ap.add_argument("--n", type=int, default=56, help="total utts (half fit, half eval)")
    ap.add_argument("--seed", type=int, default=97531)
    ap.add_argument("--ridge", type=float, default=1.0)
    ap.add_argument("--out-dir", default="runs/pitch_decodability_probe")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Print and write the probe's numbers (the JAX script's keys)."""
    args = parse_args(argv)
    from .api import resolve_device
    from .train.synthesis_loop import build_synthesis_corpus, precompute_features

    device = resolve_device(args.device)
    model, meta = load_encoder(args.encoder, device)
    corpus = build_synthesis_corpus(args.n, 5.0, seed=args.seed, style=args.style)
    feats = precompute_features(model, corpus["wav"], float(meta["norm_threshold"]),
                                float(meta.get("merge_threshold", 0.8)), batch=8).cpu().numpy()
    art = corpus["art"]
    L = min(feats.shape[1], art.shape[1])
    feats, art = feats[:, :L], art[:, :L]
    pitch = art[..., 12]
    voiced = art[..., 13] > 0.02

    half = args.n // 2
    Xf = feats[:half][voiced[:half]]
    yf = pitch[:half][voiced[:half]]
    X = np.concatenate([Xf, np.ones((len(Xf), 1), Xf.dtype)], 1).astype(np.float64)
    A = X.T @ X + args.ridge * np.eye(X.shape[1])
    w = np.linalg.solve(A, X.T @ yf.astype(np.float64))

    Fe = feats[half:]
    pred = (Fe.reshape(-1, Fe.shape[-1]).astype(np.float64) @ w[:-1] + w[-1]).reshape(Fe.shape[:2])
    mean_r, rs = per_utt_mean_removed_corr(pred, pitch[half:], voiced[half:])
    pv = pred[voiced[half:]]
    tv = pitch[half:][voiced[half:]]
    out = {"encoder": args.encoder, "style": args.style, "n_fit": half, "n_eval": args.n - half,
           "per_utt_mean_removed_pitch_r": mean_r,
           "per_utt_r_p10": float(np.percentile(rs, 10)),
           "per_utt_r_median": float(np.median(rs)),
           "pooled_pitch_r": float(np.corrcoef(pv, tv)[0, 1])}
    print(json.dumps(out, indent=2))
    path = Path(args.out_dir) / "pitch_decodability_probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
