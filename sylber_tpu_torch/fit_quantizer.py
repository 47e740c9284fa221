"""Fit k-means syllable-token codebooks (the 5K/10K/20K-unit variants).

Port of ``scripts/fit_quantizer.py``: a manifest of names and a directory of
audio (WAV, FLAC or OGG, through ``utils/audio.py::load_for_inference``) ->
the ``Segmenter``'s pooled segment features, ``--batch-size`` utterances a
call -> ``flow/kmeans.py::fit_kmeans`` -> the centroids as a ``.npy`` (K, d)
float32, the layout ``quantizer.py::KMQuantizer`` and the JAX package's
``KMQuantizer`` load. ``--residual-out`` also fits a second codebook on the
residual ``features - decode(indices)``, as ``ResidualKMQuantizer``
encodes it (with ``--normalize`` the first stage's indices are those of the
normalised features, as ``ResidualKMQuantizer(normalize=True)`` takes them).

    python -m sylber_tpu_torch.fit_quantizer --manifest tags.txt --wav-dir wavs/ \\
        --ckpt sylber.ckpt --n-clusters 5000 --out centroids_5k.npy \\
        [--residual-out centroids_5k_res.npy] [--model-config mini_ckpt.json]

``--ckpt`` and ``--model-config`` are ``segment_corpus``'s: a JAX-layout
``.npz`` or a PyTorch state dict, and a JSON file whose ``hubert`` object and
``encoding_layer`` give the encoder's widths (HuBERT base, 9 layers, by
default) and its ``norm_threshold``, where it has one (else the
``Segmenter``'s 2.6). It runs on ``cuda`` unless ``--device cpu`` is given,
and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", required=True, help="one name a line")
    ap.add_argument("--wav-dir", required=True,
                    help="<wav-dir>/<name>.wav (or .flac, .ogg) for each name")
    ap.add_argument("--ckpt", default=None,
                    help="a JAX-layout .npz or a PyTorch state dict; none: seeded random "
                         "weights")
    ap.add_argument("--model-config", default=None,
                    help="JSON file with the encoder's 'hubert' widths and 'encoding_layer' "
                         "(e.g. tests/fixtures/mini_ckpt.json)")
    ap.add_argument("--n-clusters", type=int, default=5000)
    ap.add_argument("--out", default="runs/fit_quantizer/centroids.npy")
    ap.add_argument("--residual-out", default=None,
                    help="also fit a second-stage residual codebook and write it here")
    ap.add_argument("--normalize", action="store_true",
                    help="fit on features scaled to norm 6 (KMQuantizer(normalize=True))")
    ap.add_argument("--max-utts", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--precision", default="highest", choices=["default", "highest"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def pooled_features(seg, wavs: List[np.ndarray], batch_size: int) -> np.ndarray:
    """The segment features of every utterance, ``batch_size`` a
    ``Segmenter.process`` call, stacked (N, d)."""
    feats = []
    for i in range(0, len(wavs), batch_size):
        outs = seg.process(wavs[i: i + batch_size], in_second=False, return_hidden=False)
        feats += [o["segment_features"] for o in outs if len(o["segment_features"])]
        print(f"\r{min(i + batch_size, len(wavs))}/{len(wavs)}", end="", flush=True)
    print()
    return np.concatenate(feats, axis=0)


def residual(feats: np.ndarray, centroids: np.ndarray, normalize: bool, device) -> np.ndarray:
    """``feats - decode(get_indices(feats))`` under ``KMQuantizer(centroids,
    normalize)``: what the second stage of ``ResidualKMQuantizer`` encodes."""
    from .quantizer import KMQuantizer, tokens_in_blocks

    km = KMQuantizer(centroids, normalize=normalize, device=device)
    return feats - km.decode(tokens_in_blocks(km, feats)).cpu().numpy()


def main(argv=None) -> Dict[str, Any]:
    """Pool, fit and write; returns the pooled features, the centroids and
    the timings (``segments_per_s``, ``fit_seconds``)."""
    args = parse_args(argv)
    from .api import Segmenter, resolve_device
    from .flow.kmeans import fit_kmeans
    from .segment_corpus import model_widths, segmenter_config, tag_path
    from .utils.audio import load_for_inference

    device = resolve_device(args.device)
    meta = json.loads(Path(args.model_config).read_text()) if args.model_config else {}
    seg = Segmenter(model_ckpt=args.ckpt,
                    hubert_config=segmenter_config(args.dtype, args.precision,
                                                   model_widths(args.model_config)),
                    norm_threshold=meta.get("norm_threshold", 2.6), device=device)
    tags = [t.strip() for t in open(args.manifest) if t.strip()]
    if args.max_utts:
        tags = tags[: args.max_utts]
    wavs = [load_for_inference(tag_path(args.wav_dir, t)) for t in tags]

    t0 = time.perf_counter()
    feats = pooled_features(seg, wavs, args.batch_size)
    pool_s = time.perf_counter() - t0
    print(f"{len(feats)} segment features from {len(wavs)} utterances in {pool_s:.2f} s")

    t0 = time.perf_counter()
    centroids, inertia = fit_kmeans(feats, args.n_clusters, normalize=args.normalize,
                                    device=device)
    fit_s = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.save(args.out, centroids)
    print(f"wrote {args.out} (inertia {inertia:.3f}, fit {fit_s:.2f} s)")
    out = {"features": feats, "centroids": centroids, "inertia": inertia,
           "segments": int(len(feats)), "pool_seconds": pool_s,
           "segments_per_s": len(feats) / max(pool_s, 1e-9), "fit_seconds": fit_s}

    if args.residual_out:
        res = residual(feats, centroids, args.normalize, device)
        t0 = time.perf_counter()
        c2, inertia2 = fit_kmeans(res, args.n_clusters, device=device)
        out.update(residual=res, residual_centroids=c2, residual_inertia=inertia2,
                   residual_fit_seconds=time.perf_counter() - t0)
        Path(args.residual_out).parent.mkdir(parents=True, exist_ok=True)
        np.save(args.residual_out, c2)
        print(f"wrote {args.residual_out} (inertia {inertia2:.3f})")
    return out


if __name__ == "__main__":
    main()
