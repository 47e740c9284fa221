"""Representation ceiling for per-utterance pitch modulation.

Port of ``scripts/pitch_modulation_ceiling_probe.py``. The resynthesis chain
conditions the CFM on segment-averaged features filled constant across each
segment's frames, so within a syllable the conditioning cannot represent a
pitch contour: the best any decoder conditioned this way can do is the
per-segment mean. This probe measures that ceiling with no model on the
pitch side, scored by the chain's per-utterance mean-removed pitch-modulation
metric (``utils/metrics.py::per_utterance_pitch_modulation``):

- ``oracle_segment_fill``: the per-segment voiced mean of the TRUE pitch
  track filled across each segment, the segments those of the trained mini
  encoder (``token_chain_proof.build_synth(style="rich")``'s, through the
  segmentation kernels, in batches of 8 padded with silence);
- ``oracle_truth_segments``: the same over the analytic syllable spans.

The held-out set is the rich corpus of seed 90001 rebuilt with its analytic
spans (``build_synthesis_corpus``'s draws, the same samples). Writes
``<out-dir>/pitch_modulation_ceiling_probe.json``:

    python -m sylber_tpu_torch.pitch_modulation_ceiling_probe [--n-eval 48]
        [--seconds 5] [--out-dir runs/pitch_modulation_ceiling_probe]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

from .token_chain_proof import HELDOUT_SEED, build_synth, segment_features
from .train.synthesis_loop import BUFFER, FRAME, SR, padded_batches
from .utils.metrics import per_utterance_pitch_modulation

NOTE = ("per-utt mean-removed pitch corr of segment-constant TRUE pitch vs the true contour "
        "— the representation ceiling of segment-averaged conditioning")


def fill_segment_means(pitch: np.ndarray, loud: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """Per-segment voiced-mean pitch filled across each span's frames."""
    out = np.zeros_like(pitch)
    for a, b in spans:
        a, b = max(int(a), 0), min(int(b), len(pitch))
        if b <= a:
            continue
        v = loud[a:b] > 0.02
        out[a:b] = pitch[a:b][v].mean() if v.any() else 0.0
    return out


def heldout_with_spans(n_eval: int, seconds: float) -> Dict[str, Any]:
    """The rich held-out corpus (seed 90001) with its analytic syllable
    spans: ``build_synthesis_corpus``'s draws and padding, the spans kept."""
    from .data.dataset import _zero_mean_unit_var
    from .data.synthetic import synth_utterance

    n_samples = int(seconds * SR) // FRAME * FRAME
    rng = np.random.RandomState(HELDOUT_SEED)
    pad = np.zeros(BUFFER, np.float32)
    wavs, arts, spans = [], [], []
    for _ in range(n_eval):
        wav, segs, art = synth_utterance(rng, n_samples, return_art=True, style="rich")
        wavs.append(np.concatenate([pad, _zero_mean_unit_var(wav), pad]))
        arts.append(art)
        spans.append(np.asarray(segs))
    return {"wav": np.stack(wavs), "art": np.stack(arts), "segments": spans}


def as_art(pitch: np.ndarray, shape) -> np.ndarray:
    """(B, L) pitch as the channel 12 of a (B, L, 14) art, for the metric."""
    a = np.zeros(shape, np.float32)
    a[..., 12] = pitch
    return a


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-eval", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out-dir", default="runs/pitch_modulation_ceiling_probe")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Print and write the two ceilings; returns them with the encoder's
    ``segments`` of every utterance (not written)."""
    args = parse_args(argv)
    from .api import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}", flush=True)
    synth, norm_thr, merge_thr = build_synth(style="rich", device=device)
    heldout = heldout_with_spans(args.n_eval, args.seconds)
    truth = np.asarray(heldout["art"], np.float32)

    model_fill = np.zeros(truth.shape[:2], np.float32)
    segments = []
    for i, (chunk, n) in enumerate(padded_batches(heldout["wav"], 8)):
        _, s, k = segment_features(synth, chunk, norm_thr, merge_thr)
        for j in range(n):
            t = truth[i * 8 + j]
            segments.append(s[j, : int(k[j])])
            model_fill[i * 8 + j] = fill_segment_means(t[..., 12], t[..., 13], segments[-1])
    oracle_fill = np.stack([fill_segment_means(t[:, 12], t[:, 13], spans)
                            for t, spans in zip(truth, heldout["segments"])])
    out = {"n_eval_utts": args.n_eval,
           "oracle_segment_fill": per_utterance_pitch_modulation(
               as_art(model_fill, truth.shape), truth),
           "oracle_truth_segments": per_utterance_pitch_modulation(
               as_art(oracle_fill, truth.shape), truth),
           "note": NOTE}
    print(json.dumps(out, indent=2))
    path = Path(args.out_dir) / "pitch_modulation_ceiling_probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return dict(out, segments=segments)


if __name__ == "__main__":
    main()
