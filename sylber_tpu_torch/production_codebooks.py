"""Production-scale syllable codebooks: 5K / 10K / 20K units.

Port of ``scripts/production_codebooks.py``. The rich synthetic corpus
saturates k-means near 1.1K clusters (its segment features sit on a
160-phoneme x 12-speaker grid), so the production sizes are fit on the
continuum corpus (``data/synthetic.py`` style ``continuum``: continuous
speakers, per-syllable formant and articulatory perturbation) and checked
two ways:

1. the trained v1 mini encoder's segment features (``mini_ckpt.npz``) pooled
   over N continuum utterances, generated and encoded in chunks so the host
   holds one chunk of audio at a time, with each segment's mean log-pitch
   and voiced fraction from the analytic truth
   (:func:`collect_features_with_truth`);
2. 5,000 / 10,000 / 20,000 centres fit on the device (``fit_kmeans``:
   the k-means++ seeding kernel, mini-batch Lloyd, dead-cluster reseeding);
3. each codebook's usage over the whole pooled set, its quantization SNR
   (tokens taken 16,384 rows at a time: an (N, K) distance block at N 110k,
   K 20k would be 8.8 GB), and a ridge probe's held-out pitch correlation
   on quantized against continuous features (:func:`ridge_r`);
4. the chain wav -> segment -> tokenize -> CFM -> vocoder on the rich
   held-out set through ``mini_synth_rich`` and ``mini_vocoder_rich``,
   scored as ``token_chain_proof`` scores it.

Writes ``<out-dir>/token_chain_prod.json`` (the recorded table's keys;
``fit_seconds`` is this device's) and the codebooks as
``mini_codebook_prod_{K}.npy`` (float16) beside it; the fixtures are read,
never written:

    python -m sylber_tpu_torch.production_codebooks [--n-utts 8192]
        [--sizes 5000 10000 20000] [--out-dir runs/production_codebooks]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. It fails when the table misses the JAX package's gates
(:func:`gate_failures`).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from .quantizer import tokens_in_blocks
from .token_chain_proof import (HELDOUT_SEED, build_synth, load_vocoder, segment_features,
                                vocoder_leg)
from .train.synthesis_loop import eval_chain, padded_batches

TOKEN_ROWS = 16384  # rows a distance block when tokenizing the pooled set


def collect_features_with_truth(synth, norm_thr, merge_thr, n_utts, seconds=5.0, seed=0,
                                batch=32, chunk_utts=512, style="continuum"):
    """Pooled ``(features (N, d), per-segment mean log-pitch over its voiced
    frames (N,), voiced fraction (N,))``; the corpus is generated and
    encoded ``chunk_utts`` utterances at a time (chunk c seeded ``seed +
    c``), ``batch`` a forward."""
    from .train.synthesis_loop import build_synthesis_corpus

    feats_all, pitch_all, vfrac_all = [], [], []
    for c0 in range(0, n_utts, chunk_utts):
        corpus = build_synthesis_corpus(min(chunk_utts, n_utts - c0), seconds, seed=seed + c0,
                                        style=style)
        arts = corpus["art"]
        for bi, (chunk, n) in enumerate(padded_batches(corpus["wav"], batch)):
            f, s, k = segment_features(synth, chunk, norm_thr, merge_thr)
            for j in range(n):
                art = arts[bi * batch + j]
                L = art.shape[0]
                for seg in range(int(k[j])):
                    a, b = max(int(s[j, seg, 0]), 0), min(int(s[j, seg, 1]), L)
                    if b <= a:
                        continue
                    span = art[a:b]
                    voiced = span[:, 13] > 0.02
                    feats_all.append(f[j, seg])
                    pitch_all.append(float(span[voiced, 12].mean()) if voiced.any() else 0.0)
                    vfrac_all.append(float(voiced.mean()))
        print(f"  chunk {c0 + len(arts)}/{n_utts}: {len(feats_all)} segments pooled",
              flush=True)
    return (np.stack(feats_all), np.asarray(pitch_all, np.float32),
            np.asarray(vfrac_all, np.float32))


def ridge_r(x: np.ndarray, y: np.ndarray, lam: float = 1.0, seed: int = 0) -> float:
    """Held-out Pearson r of a ridge probe x -> y (an 80/20 split)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(x))
    n_tr = int(0.8 * len(x))
    tr, te = idx[:n_tr], idx[n_tr:]
    xm, xs = x[tr].mean(0), x[tr].std(0) + 1e-6
    xt = (x[tr] - xm) / xs
    w = np.linalg.solve(xt.T @ xt + lam * np.eye(x.shape[1]), xt.T @ (y[tr] - y[tr].mean()))
    pred = ((x[te] - xm) / xs) @ w
    yt = y[te] - y[tr].mean()
    pred, yt = pred - pred.mean(), yt - yt.mean()
    den = np.sqrt((pred ** 2).sum() * (yt ** 2).sum()) + 1e-12
    return float((pred * yt).sum() / den)


def quantization_stats(quantizer, feats: np.ndarray):
    """``(tokens (N,), quantized features (N, d), usage, SNR in dB)`` of
    ``feats`` under ``quantizer``, tokens ``TOKEN_ROWS`` rows at a time."""
    toks = tokens_in_blocks(quantizer, feats, TOKEN_ROWS)
    quant = quantizer.decode(toks).cpu().numpy()
    snr = 10.0 * np.log10((feats ** 2).sum(-1).mean()
                          / (((feats - quant) ** 2).sum(-1).mean() + 1e-12))
    return toks, quant, int(len(np.unique(toks))), float(snr)


def _km_keys(t) -> List[str]:
    return sorted((k for k in t if k.startswith("km")), key=lambda k: int(k[2:]))


def gate_failures(out: Dict[str, Any], chain: bool = True) -> List[str]:
    """The JAX package's gates on the table
    (``tests/parity/test_token_chain_prod.py:57-117``); the chain's only
    where ``chain``. Returns the gates missed."""
    t = out["table"]
    fc = out["fit_corpus"]
    bad = []

    def gate(name, ok):
        if not ok:
            bad.append(name)

    keys = _km_keys(t)
    gate(f"fit corpus continuum with >= 100,000 segments ({fc})",
         fc["style"] == "continuum" and fc["n_segments"] >= 100_000)
    gate(f"smallest codebook >= 5000 ({keys})", min(int(k[2:]) for k in keys) >= 5000)
    usage = {int(k[2:]): t[k]["codebook_usage"] for k in keys}
    gate(f"usage km5000 == 5000 ({usage.get(5000)})", usage.get(5000) == 5000)
    gate(f"usage km10000 >= 7000 ({usage.get(10000)})", (usage.get(10000) or 0) >= 7000)
    gate(f"usage km20000 >= 7000 ({usage.get(20000)})", (usage.get(20000) or 0) >= 7000)
    gate(f"usage km20000 >= km10000's - 500 ({usage})",
         (usage.get(20000) or 0) >= (usage.get(10000) or 0) - 500)
    r_cont = t["features"]["pitch_ridge_r"]
    gate(f"continuous pitch ridge r >= 0.9 ({r_cont})", r_cont >= 0.9)
    snrs = [t[k]["quant_snr_db"] for k in keys]
    gate(f"SNR km5000 >= 25 dB ({snrs})", snrs[0] >= 25.0)
    gate(f"SNR of the larger codebooks >= 40 dB ({snrs})", all(s >= 40.0 for s in snrs[1:]))
    inertias = [t[k]["kmeans_inertia"] for k in keys]
    gate(f"inertia falling with K ({inertias})", inertias == sorted(inertias, reverse=True))
    for k in keys:
        gate(f"{k} pitch ridge r >= continuous - 0.03 and >= 0.9 ({t[k]['pitch_ridge_r']})",
             t[k]["pitch_ridge_r"] >= r_cont - 0.03 and t[k]["pitch_ridge_r"] >= 0.9)
    if not chain:
        return bad
    f = t["features"]
    gate(f"features pitch_corr > 0.8 ({f['pitch_corr']})", f["pitch_corr"] > 0.8)
    gate(f"features loud_corr > 0.7 ({f['loud_corr']})", f["loud_corr"] > 0.7)
    gate(f"features pitch_mod_r >= 0.5 ({f['pitch_mod_r']})", f["pitch_mod_r"] >= 0.5)
    gate(f"features vocoder f0_corr >= 0.4 ({f['vocoder']['f0_corr']})",
         f["vocoder"]["f0_corr"] >= 0.4)
    for k in keys:
        m = t[k]
        gate(f"{k} pitch_corr > features' - 0.05 and > 0.8 ({m['pitch_corr']})",
             m["pitch_corr"] > f["pitch_corr"] - 0.05 and m["pitch_corr"] > 0.8)
        gate(f"{k} loud_corr > features' - 0.05 and > 0.7 ({m['loud_corr']})",
             m["loud_corr"] > f["loud_corr"] - 0.05 and m["loud_corr"] > 0.7)
        gate(f"{k} pitch_l1_voiced < features' + 0.04 ({m['pitch_l1_voiced']})",
             m["pitch_l1_voiced"] < f["pitch_l1_voiced"] + 0.04)
        gate(f"{k} pitch_mod_r >= 0.45 ({m['pitch_mod_r']})", m["pitch_mod_r"] >= 0.45)
        gate(f"{k} vocoder f0_corr >= 0.4 ({m['vocoder']['f0_corr']})",
             m["vocoder"]["f0_corr"] >= 0.4)
        gate(f"{k} vocoder periodicity >= 0.7 ({m['vocoder']['periodicity']})",
             m["vocoder"]["periodicity"] >= 0.7)
    return bad


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[5000, 10000, 20000])
    ap.add_argument("--n-utts", type=int, default=8192)
    ap.add_argument("--n-eval", type=int, default=48)
    ap.add_argument("--steps", type=int, default=50, help="ODE steps")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--skip-chain", action="store_true",
                    help="intrinsic metrics only (no CFM and vocoder legs)")
    ap.add_argument("--out-dir", default="runs/production_codebooks")
    ap.add_argument("--out", default=None,
                    help="the table's path (default <out-dir>/token_chain_prod.json)")
    ap.add_argument("--skip-gates", action="store_true",
                    help="report the gates the table misses without failing (short runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Pool, fit, measure and write the table; returns it with ``"seconds"``
    and ``"gates_missed"`` (not written)."""
    args = parse_args(argv)
    from .api import resolve_device
    from .flow.kmeans import fit_kmeans
    from .quantizer import KMQuantizer
    from .train.synthesis_loop import build_synthesis_corpus

    device = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"device: {device}", flush=True)
    synth, norm_thr, merge_thr = build_synth(style="rich", device=device)
    seconds = {}

    t0 = time.perf_counter()
    feats, pitch_truth, vfrac = collect_features_with_truth(synth, norm_thr, merge_thr,
                                                            n_utts=args.n_utts,
                                                            seconds=args.seconds)
    seconds["pool"] = time.perf_counter() - t0
    print(f"pooled {feats.shape} continuum segment features in {seconds['pool']:.1f} s",
          flush=True)
    voiced_seg = vfrac > 0.5
    ys = pitch_truth[voiced_seg]
    r_cont = ridge_r(feats[voiced_seg], ys)
    print(f"continuous-feature pitch ridge r = {r_cont:.3f} ({voiced_seg.sum()} voiced "
          "segments)", flush=True)

    table: Dict[str, Any] = {"features": {"pitch_ridge_r": r_cont}}
    if not args.skip_chain:
        heldout = build_synthesis_corpus(args.n_eval, args.seconds, seed=HELDOUT_SEED,
                                         style="rich")
        vocoder = load_vocoder("mini_vocoder_rich", device)
        art, m = eval_chain(synth, norm_thr, merge_thr, heldout, steps=args.steps)
        m["vocoder"] = vocoder_leg(art, heldout, vocoder=vocoder)
        table["features"].update(m)
        print("features:", json.dumps(table["features"]), flush=True)

    codebook_files = {}
    for K in args.sizes:
        t0 = time.perf_counter()
        cents, inertia = fit_kmeans(feats, K, seed=0, device=device)
        seconds[f"km{K}_fit"] = time.perf_counter() - t0
        q = KMQuantizer(cents, device=device)
        _, quant, usage, snr = quantization_stats(q, feats)
        # fit_seconds spans what the JAX script's does: the fit and the intrinsic metrics
        m = {"kmeans_inertia": float(inertia), "codebook_usage": usage,
             "quant_snr_db": round(snr, 2), "pitch_ridge_r": ridge_r(quant[voiced_seg], ys),
             "fit_seconds": round(time.perf_counter() - t0, 1)}
        name = f"mini_codebook_prod_{K}.npy"
        np.save(out_dir / name, cents.astype(np.float16))
        codebook_files[K] = name
        if not args.skip_chain:
            synth.quantizer = q
            art, mc = eval_chain(synth, norm_thr, merge_thr, heldout, steps=args.steps)
            synth.quantizer = None
            mc["vocoder"] = vocoder_leg(art, heldout, vocoder=vocoder)
            m.update(mc)
        table[f"km{K}"] = m
        print(f"km{K}:", json.dumps(m), flush=True)

    out = {"chain": "continuum-corpus codebooks; chain eval on rich held-out",
           "fit_corpus": {"style": "continuum", "n_utts": args.n_utts,
                          "n_segments": int(len(feats)),
                          "n_voiced_segments": int(voiced_seg.sum())},
           "encoder": "tests/fixtures/mini_ckpt.npz",
           "cfm": "tests/fixtures/mini_synth_rich.npz",
           "vocoder_ckpt": "tests/fixtures/mini_vocoder_rich.npz",
           "codebooks": codebook_files, "ode_steps": args.steps, "n_eval_utts": args.n_eval,
           "table": table}
    out_path = Path(args.out or out_dir / "token_chain_prod.json")
    out_path.write_text(json.dumps(out, indent=2))
    print(f"wrote {out_path}")
    failed = gate_failures(out, chain=not args.skip_chain)
    if failed and not args.skip_gates:
        raise AssertionError(f"the production codebooks miss the JAX package's gates: {failed}")
    return dict(out, seconds=seconds, gates_missed=failed)


if __name__ == "__main__":
    main()
