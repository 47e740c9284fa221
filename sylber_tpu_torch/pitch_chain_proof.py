"""Explicit-pitch token chain proof: wav -> (art tokens + pitch tokens) ->
CFM -> vocoder audio.

Port of ``scripts/pitch_chain_proof.py``. The explicit-pitch CFM
(``SynthesisConfig.explicit_pitch_cond``, ``ops/pitch.py``) is conditioned
on the per-segment mean log-F0 measured from the input audio, and
``flow/quantizer.py::ScalarPitchQuantizer`` turns that channel into tokens,
so the token chain keeps an explicit pitch stream. On the trained fixtures
(the frozen v1 mini encoder, ``mini_synth_rich_pitch``, ``mini_vocoder_rich``;
read, never written) and the rich held-out set (seed 90001), four rows:

- ``true_art``: the analytic articulatory truth through the vocoder (the
  audio F0 ceiling);
- ``features``: continuous segment features and the continuous measured
  pitch channel;
- ``km1024``: ``mini_codebook_rich_1024.npy`` art tokens and the continuous
  pitch channel;
- ``km1024+p64``: art tokens and 64-bin scalar pitch tokens (65 with the
  unvoiced token), the fully discrete chain.

Writes ``<out-dir>/token_chain_rich_pitch.json`` (the recorded table's keys):

    python -m sylber_tpu_torch.pitch_chain_proof [--n-eval 24] [--out-dir runs/pitch_chain]

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

from .token_chain_proof import FIXTURES, HELDOUT_SEED, load_synth, load_vocoder, vocoder_leg
from .train.synthesis_loop import eval_chain

ART_CODEBOOK = "mini_codebook_rich_1024.npy"


def build_pitch_synth(quantizer=None, pitch_quantizer=None, device=None):
    """The frozen v1 mini encoder and the trained explicit-pitch rich CFM
    (``mini_synth_rich_pitch``): ``(synth, norm threshold, merge threshold)``."""
    return load_synth("sylber_resynthesis_rich_pitch_mini.yaml", "mini_synth_rich_pitch.npz",
                      quantizer=quantizer, pitch_quantizer=pitch_quantizer, device=device)


def gate_failures(out: Dict[str, Any]) -> List[str]:
    """The JAX package's gates on the table
    (``tests/parity/test_token_chain_pitch.py:118-135``); the gates missed."""
    t = out["table"]
    bad = []

    def gate(name, ok):
        if not ok:
            bad.append(name)

    gate(f"true_art vocoder f0_corr >= 0.9 ({t['true_art']['vocoder']['f0_corr']})",
         t["true_art"]["vocoder"]["f0_corr"] >= 0.9)
    gate(f"features pitch_mod_r >= 0.8 ({t['features']['pitch_mod_r']})",
         t["features"]["pitch_mod_r"] >= 0.8)
    gate(f"features pitch_corr >= 0.9 ({t['features']['pitch_corr']})",
         t["features"]["pitch_corr"] >= 0.9)
    gate(f"km1024 pitch_mod_r >= 0.75 ({t['km1024']['pitch_mod_r']})",
         t["km1024"]["pitch_mod_r"] >= 0.75)
    p = [k for k in t if k.startswith("km1024+p")]
    gate("a km1024+p row", bool(p))
    if p:
        m = t[p[0]]
        gate(f"{p[0]} pitch_mod_r >= 0.75 ({m['pitch_mod_r']})", m["pitch_mod_r"] >= 0.75)
        gate(f"{p[0]} pitch_l1_voiced < 0.08 ({m['pitch_l1_voiced']})",
             m["pitch_l1_voiced"] < 0.08)
        gate(f"{p[0]} vocoder f0_corr >= 0.6 ({m['vocoder']['f0_corr']})",
             m["vocoder"]["f0_corr"] >= 0.6)
    return bad


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-eval", type=int, default=24)
    ap.add_argument("--steps", type=int, default=50, help="ODE steps")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--pitch-bins", type=int, default=64)
    ap.add_argument("--out-dir", default="runs/pitch_chain")
    ap.add_argument("--out", default=None,
                    help="the table's path (default <out-dir>/token_chain_rich_pitch.json)")
    ap.add_argument("--skip-gates", action="store_true",
                    help="report the gates the table misses without failing (short runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Run the rows and write the table; returns it with ``"gates_missed"``
    (not written)."""
    args = parse_args(argv)
    from .api import resolve_device
    from .flow.quantizer import ScalarPitchQuantizer
    from .quantizer import KMQuantizer
    from .train.synthesis_loop import build_synthesis_corpus

    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    heldout = build_synthesis_corpus(args.n_eval, args.seconds, seed=HELDOUT_SEED, style="rich")
    cents = np.load(FIXTURES / ART_CODEBOOK).astype(np.float32)
    vocoder = load_vocoder("mini_vocoder_rich", device)

    table = {}
    t0 = time.perf_counter()
    table["true_art"] = {"vocoder": vocoder_leg(np.asarray(heldout["art"], np.float32),
                                                heldout, vocoder=vocoder)}
    print("true_art:", json.dumps(table["true_art"]), flush=True)
    legs = [("features", None, None), ("km1024", KMQuantizer(cents, device=device), None),
            (f"km1024+p{args.pitch_bins}", KMQuantizer(cents, device=device),
             ScalarPitchQuantizer(args.pitch_bins))]
    for name, q, p in legs:
        synth, norm_thr, merge_thr = build_pitch_synth(quantizer=q, pitch_quantizer=p,
                                                       device=device)
        art, m = eval_chain(synth, norm_thr, merge_thr, heldout, steps=args.steps)
        m["vocoder"] = vocoder_leg(art, heldout, vocoder=vocoder)
        table[name] = m
        print(f"{name}:", json.dumps(m), f"[{time.perf_counter() - t0:.0f} s]", flush=True)

    out = {"chain": "wav -> segment -> (art tokens + pitch tokens) -> CFM -> vocoder",
           "style": "rich", "encoder": "tests/fixtures/mini_ckpt.npz",
           "cfm": "tests/fixtures/mini_synth_rich_pitch.npz",
           "vocoder_ckpt": "tests/fixtures/mini_vocoder_rich.npz",
           "art_codebook": ART_CODEBOOK, "pitch_bins": args.pitch_bins,
           "ode_steps": args.steps, "n_eval_utts": args.n_eval, "table": table}
    out_path = Path(args.out or Path(args.out_dir) / "token_chain_rich_pitch.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(f"wrote {out_path}")
    failed = gate_failures(out)
    if failed and not args.skip_gates:
        raise AssertionError(f"the pitch chain misses the JAX package's gates: {failed}")
    return dict(out, gates_missed=failed)


if __name__ == "__main__":
    main()
