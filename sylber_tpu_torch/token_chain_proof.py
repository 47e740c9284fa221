"""Discrete-token chain proof: wav -> syllable tokens -> CFM -> vocoder audio.

Port of ``scripts/token_chain_proof.py``, on the trained mini fixtures of
``tests/fixtures`` (read, never written):

1. k-means codebooks of several sizes fit (``flow/kmeans.py::fit_kmeans``)
   on the pooled segment features of the trained mini encoder
   (``mini_ckpt.npz``) over the synthetic training corpus;
2. for each size the whole chain on held-out utterances (seed 90001):
   wav -> segmentation -> nearest centroid -> decoded tokens -> frame fill
   -> CFM (``SegmentSynthesis.resynthesize(input_values=...)`` with the
   quantizer, all on the device), scored against the analytic articulatory
   truth (:func:`~sylber_tpu_torch.train.synthesis_loop.eval_chain`);
3. the chain without a quantizer as the reference point, and the true
   articulatory tracks through the vocoder as the vocoder's ceiling;
4. a vocoder leg for each (:func:`vocoder_leg`): the chain's art through
   the trained mini HiFi-GAN, the per-utterance mean-removed F0 track's
   correlation with the real audio.

``--codebooks recorded`` evaluates the checked-in codebooks
(``mini_codebook{_rich}_{K}.npy``) instead of refitting, so the weights, the
held-out audio and the codebooks are those of the recorded table
(``token_chain{_rich}.json``); the features are still pooled for the usage
count. A refit draws from torch generators, not JAX's, so its codebooks
differ from the recorded ones and only the gates judge it.

Writes ``<out-dir>/token_chain{_rich}.json`` (the recorded table's keys) and
the refit codebooks as ``mini_codebook{_rich}_{K}.npy`` (float16) beside it:

    python -m sylber_tpu_torch.token_chain_proof [--style v1|rich]
        [--codebooks refit|recorded] [--sizes 64 256 1024] [--out-dir runs/token_chain]

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

from .train.synthesis_loop import eval_chain, padded_batches
from .utils.metrics import pearson

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
HELDOUT_SEED = 90001  # the synthesis trainers' eval seed
DEFAULT_SIZES = {"v1": [64, 256, 1024], "rich": [64, 256, 1024, 4096]}


def mini_thresholds():
    """The trained mini encoder's (norm, merge) thresholds."""
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    return float(meta["norm_threshold"]), float(meta["merge_threshold"])


def load_synth(config_name: str, cfm_name: str, quantizer=None, pitch_quantizer=None,
               device=None):
    """A ``SegmentSynthesis`` of the frozen mini encoder and a trained CFM
    fixture, its model block from ``configs/<config_name>``: ``(synth, norm
    threshold, merge threshold)``."""
    import yaml

    from .io.checkpoint import load_params_npz
    from .synthesis import SegmentSynthesis, synthesis_config_from_dict

    cfg = yaml.safe_load((ROOT / "configs" / config_name).read_text())
    sc = synthesis_config_from_dict(dict(cfg["model"]))
    params = {"hubert": load_params_npz(str(FIXTURES / "mini_ckpt.npz")),
              **load_params_npz(str(FIXTURES / cfm_name))}
    synth = SegmentSynthesis(config=sc, params=params, quantizer=quantizer,
                             pitch_quantizer=pitch_quantizer, device=device)
    return (synth,) + mini_thresholds()


def build_synth(quantizer=None, style: str = "v1", device=None):
    """The trained mini encoder and the trained mini CFM (``mini_synth``, or
    ``mini_synth_rich`` over the same v1 encoder for ``style="rich"``)."""
    rich = style == "rich"
    return load_synth("sylber_resynthesis_rich_mini.yaml" if rich
                      else "sylber_resynthesis_mini.yaml",
                      "mini_synth_rich.npz" if rich else "mini_synth.npz",
                      quantizer=quantizer, device=device)


def segment_features(synth, wav: np.ndarray, norm_thr: float, merge_thr: float):
    """The encoder, the segmentation and the pooling on one batch of
    equal-length utterances: ``(features (B, MS, d), segments (B, MS, 2),
    counts (B,))`` on the host."""
    import torch

    from .models.hubert import matmul_precision
    from .ops.segment import segment_batch

    with torch.inference_mode():
        w = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(synth.device)
        hidden = synth.hubert(w, None).float()
        with matmul_precision("highest"):
            res = segment_batch(hidden, norm_thr, merge_thr)
        return (res.features.cpu().numpy(), res.segments.cpu().numpy(),
                res.num_segments.cpu().numpy())


def collect_segment_features(synth, norm_thr, merge_thr, n_utts=256, seconds=5.0, seed=0,
                             batch=32, style="v1") -> np.ndarray:
    """Pooled segment features over the synthetic corpus, stacked (N, d)."""
    from .train.synthesis_loop import build_synthesis_corpus

    corpus = build_synthesis_corpus(n_utts, seconds, seed=seed, style=style)
    out = []
    for chunk, n in padded_batches(corpus["wav"], batch):
        f, _, k = segment_features(synth, chunk, norm_thr, merge_thr)
        out += [f[j, : k[j]] for j in range(n)]
    return np.concatenate(out, axis=0)


def load_vocoder(prefix: str = "mini_vocoder", device=None):
    """The trained mini vocoder fixture: ``(SparcDecoder, its metadata)``."""
    from .io.checkpoint import load_params_npz
    from .vocoder import HiFiGANConfig, SparcDecoder, SparcDecoderConfig

    meta = json.loads((FIXTURES / f"{prefix}.json").read_text())
    dcfg = SparcDecoderConfig(generator=HiFiGANConfig(**meta["generator"]))
    return SparcDecoder(dcfg, params=load_params_npz(str(FIXTURES / f"{prefix}.npz")),
                        device=device), meta


def vocoder_leg(art, heldout, vocoder_prefix="mini_vocoder", device=None, noise=None,
                vocoder=None) -> Dict[str, Any]:
    """(Token-)resynthesized art -> the trained mini HiFi-GAN -> the mean of
    the per-utterance mean-removed correlation of the audio's
    autocorrelation F0 track with the real waveform's, over the frames both
    tracks find strongly periodic, and the audio's median periodicity there.
    ``noise``: the harmonic source's noise channel, else the generator's
    seeded draw; ``vocoder``: a loaded ``(SparcDecoder, meta)``."""
    import torch

    from .vocoder_proof import f0_track_autocorr

    dec, meta = vocoder or load_vocoder(vocoder_prefix, device)
    spk = np.zeros((len(art), dec.config.generator.cond_channels), np.float32)
    audio = dec.waveform(art, spk, meta["pitch_mean"],
                         noise=None if noise is None else torch.as_tensor(noise).to(dec.device))
    audio = audio.cpu().numpy()
    buf = 160  # the corpus's zero padding at the start
    f0_corrs, periodicity = [], []
    for i in range(len(audio)):
        real = heldout["wav"][i][buf: buf + audio.shape[1]]
        f_r, s_r = f0_track_autocorr(real)
        f_f, s_f = f0_track_autocorr(audio[i])
        voiced = (s_r > 0.4) & (s_f > 0.4)
        if voiced.sum() > 10:
            f0_corrs.append(pearson(f_r[voiced], f_f[voiced]))
            periodicity.append(float(np.median(s_f[voiced])))
    return {"f0_corr": float(np.mean(f0_corrs)) if f0_corrs else 0.0,
            "periodicity": float(np.mean(periodicity)) if periodicity else 0.0,
            "n_utts": len(f0_corrs)}


def _km_sizes(table) -> List[int]:
    return sorted(int(k[2:]) for k in table if k.startswith("km") and k[2:].isdigit())


def gate_failures(out: Dict[str, Any]) -> List[str]:
    """The JAX package's gates on a token chain table: v1
    ``tests/parity/test_token_resynthesis.py:41-85``, rich
    ``tests/parity/test_token_chain_rich.py:49-101``. Returns the gates
    missed."""
    t = out["table"]
    f = t["features"]
    bad = []

    def gate(name, ok):
        if not ok:
            bad.append(name)

    km = _km_sizes(t)
    if out.get("style", "v1") == "rich":
        gate(f"features pitch_corr > 0.8 ({f['pitch_corr']})", f["pitch_corr"] > 0.8)
        gate(f"features loud_corr > 0.6 ({f['loud_corr']})", f["loud_corr"] > 0.6)
        deltas, floor_loud = (0.08, 0.05, 0.04, None), 0.55
    else:
        gate(f"features pitch_corr > 0.85 ({f['pitch_corr']})", f["pitch_corr"] > 0.85)
        gate(f"features loud_corr > 0.75 ({f['loud_corr']})", f["loud_corr"] > 0.75)
        gate(f"features pitch_l1_voiced < 0.15 ({f['pitch_l1_voiced']})",
             f["pitch_l1_voiced"] < 0.15)
        deltas, floor_loud = (0.05, 0.03, 0.02, 0.01), 0.6
    dp, dl, dpl, dll = deltas
    for K in km:
        m = t[f"km{K}"]
        if K >= 256:
            gate(f"km{K} pitch_corr > features' - {dp}", m["pitch_corr"] > f["pitch_corr"] - dp)
            gate(f"km{K} loud_corr > features' - {dl}", m["loud_corr"] > f["loud_corr"] - dl)
            gate(f"km{K} pitch_l1_voiced < features' + {dpl}",
                 m["pitch_l1_voiced"] < f["pitch_l1_voiced"] + dpl)
            if dll is not None:
                gate(f"km{K} loud_l1 < features' + {dll}", m["loud_l1"] < f["loud_l1"] + dll)
        gate(f"km{K} pitch_corr > 0.6 ({m['pitch_corr']})", m["pitch_corr"] > 0.6)
        gate(f"km{K} loud_corr > {floor_loud} ({m['loud_corr']})", m["loud_corr"] > floor_loud)
    usage = {K: t[f"km{K}"]["codebook_usage"] for K in km}
    if out.get("style", "v1") == "rich":
        gate(f"usage km64 == 64 ({usage.get(64)})", usage.get(64) == 64)
        gate(f"usage km256 == 256 ({usage.get(256)})", usage.get(256) == 256)
        gate(f"usage km1024 >= 900 ({usage.get(1024)})", (usage.get(1024) or 0) >= 900)
        gate(f"usage km4096 > km1024's ({usage.get(4096)})",
             (usage.get(4096) or 0) > (usage.get(1024) or 0))
        gate(f"true_art vocoder f0_corr >= 0.9 ({t['true_art']['vocoder']['f0_corr']})",
             t["true_art"]["vocoder"]["f0_corr"] >= 0.9)
        gate(f"features pitch_mod_r >= 0.5 ({f['pitch_mod_r']})", f["pitch_mod_r"] >= 0.5)
        gate(f"features vocoder f0_corr >= 0.4 ({f['vocoder']['f0_corr']})",
             f["vocoder"]["f0_corr"] >= 0.4)
        for K in km:
            if K >= 256:
                m = t[f"km{K}"]
                gate(f"km{K} pitch_mod_r >= 0.45 ({m['pitch_mod_r']})", m["pitch_mod_r"] >= 0.45)
                gate(f"km{K} vocoder f0_corr >= 0.4 ({m['vocoder']['f0_corr']})",
                     m["vocoder"]["f0_corr"] >= 0.4)
    else:
        for K, used in usage.items():
            if K <= 256:
                gate(f"usage km{K} == {K} ({used})", used == K)
            else:
                gate(f"usage km{K} >= the smaller codebooks' ({used})",
                     used >= max([u for k, u in usage.items() if k <= 256], default=0))
    return bad


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=None,
                    help="codebook sizes (default 64 256 1024; rich also 4096)")
    ap.add_argument("--n-utts", type=int, default=None,
                    help="utterances pooled for the fit (default 256; rich 1024)")
    ap.add_argument("--n-eval", type=int, default=None,
                    help="held-out utterances (default 24; rich 48)")
    ap.add_argument("--steps", type=int, default=50, help="ODE steps")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--style", default="v1", choices=["v1", "rich"],
                    help="rich: the mini_synth_rich CFM and mini_vocoder_rich fixtures")
    ap.add_argument("--codebooks", default="refit", choices=["refit", "recorded"],
                    help="refit with fit_kmeans, or evaluate the checked-in codebooks of "
                         "the recorded table")
    ap.add_argument("--out-dir", default="runs/token_chain")
    ap.add_argument("--out", default=None,
                    help="the table's path (default <out-dir>/token_chain{_rich}.json)")
    ap.add_argument("--skip-gates", action="store_true",
                    help="report the gates the table misses without failing (short runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Run the chains and write the table; returns it, with ``"seconds"``
    (the stages' walls) and ``"gates_missed"`` added (not written)."""
    args = parse_args(argv)
    from .api import resolve_device
    from .flow.kmeans import fit_kmeans
    from .quantizer import KMQuantizer, tokens_in_blocks
    from .train.synthesis_loop import build_synthesis_corpus

    device = resolve_device(args.device)
    suffix = "_rich" if args.style == "rich" else ""
    sizes = args.sizes or DEFAULT_SIZES[args.style]
    n_eval = args.n_eval or (48 if args.style == "rich" else 24)
    n_utts = args.n_utts or (1024 if args.style == "rich" else 256)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = Path(args.out or out_dir / f"token_chain{suffix}.json")
    vocoder_prefix = f"mini_vocoder{suffix}"
    print(f"device: {device}; style {args.style}; codebooks {args.codebooks}", flush=True)
    synth, norm_thr, merge_thr = build_synth(style=args.style, device=device)
    vocoder = load_vocoder(vocoder_prefix, device)
    seconds = {}

    t0 = time.perf_counter()
    feats = collect_segment_features(synth, norm_thr, merge_thr, n_utts=n_utts,
                                     seconds=args.seconds, style=args.style)
    seconds["pool"] = time.perf_counter() - t0
    print(f"pooled {feats.shape} segment features in {seconds['pool']:.1f} s", flush=True)
    heldout = build_synthesis_corpus(n_eval, args.seconds, seed=HELDOUT_SEED, style=args.style)

    table: Dict[str, Any] = {}
    t0 = time.perf_counter()
    table["true_art"] = {"vocoder": vocoder_leg(np.asarray(heldout["art"], np.float32),
                                                heldout, vocoder=vocoder)}
    art, m = eval_chain(synth, norm_thr, merge_thr, heldout, steps=args.steps)
    m["vocoder"] = vocoder_leg(art, heldout, vocoder=vocoder)
    table["features"] = m
    print("features:", json.dumps(m), flush=True)

    codebook_files = {}
    for K in sizes:
        name = f"mini_codebook{suffix}_{K}.npy"
        t1 = time.perf_counter()
        if args.codebooks == "recorded":
            cents, inertia = np.load(FIXTURES / name).astype(np.float32), None
        else:
            cents, inertia = fit_kmeans(feats, K, seed=0, device=device)
            np.save(out_dir / name, cents.astype(np.float16))
        seconds[f"fit_km{K}"] = time.perf_counter() - t1
        codebook_files[K] = name
        q = KMQuantizer(cents, device=device)
        synth.quantizer = q
        art, m = eval_chain(synth, norm_thr, merge_thr, heldout, steps=args.steps)
        m["kmeans_inertia"] = None if inertia is None else float(inertia)
        m["codebook_usage"] = int(len(np.unique(tokens_in_blocks(q, feats))))
        m["vocoder"] = vocoder_leg(art, heldout, vocoder=vocoder)
        table[f"km{K}"] = m
        print(f"km{K}:", json.dumps(m), flush=True)
    synth.quantizer = None
    seconds["chains"] = time.perf_counter() - t0

    out = {"chain": "wav -> segment -> tokenize -> decode -> CFM -> vocoder",
           "style": args.style, "encoder": "tests/fixtures/mini_ckpt.npz",
           "cfm": f"tests/fixtures/mini_synth{suffix}.npz",
           "vocoder_ckpt": f"tests/fixtures/{vocoder_prefix}.npz",
           "codebooks": codebook_files, "codebooks_from": args.codebooks, "fit_utts": n_utts,
           "ode_steps": args.steps, "n_eval_utts": n_eval, "table": table}
    out_path.write_text(json.dumps(out, indent=2))
    print(f"wrote {out_path}")
    failed = gate_failures(out)
    if failed and not args.skip_gates:
        raise AssertionError(f"the token chain misses the JAX package's gates: {failed}")
    return dict(out, seconds=seconds, gates_missed=failed)


if __name__ == "__main__":
    main()
