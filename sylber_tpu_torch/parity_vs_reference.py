"""Full checkpoint parity: the port's Segmenter against the PyTorch reference
pipeline.

Port of ``scripts/parity_vs_reference.py``. On the same utterance and the
same PyTorch checkpoint (a bare HF ``HubertModel`` state dict or a
``sylber.ckpt``-style one):

- the port: ``Segmenter(model_ckpt=..., precision="highest")`` (TF32 off),
  the weights through ``io/torch_convert.py::load_torch_checkpoint``, on
  ``cuda`` unless ``--device cpu`` is given, with a length bucket of the
  utterance's own length: the reference runs the utterance unpadded, and a
  Segmenter's padding to its 1 s buckets moves every hidden state (layer
  0's GroupNorm and the attention see the padded tail; the JAX script keeps
  the default bucket);
- the reference: HF ``transformers.HubertModel(HubertConfig(
  num_hidden_layers=...))`` on the CPU in float32, its last hidden state
  segmented by ``ops/segment_np.py::segment_oracle`` (the numpy oracle that
  matches the original repository's ``get_segment`` bit for bit) and
  mean-pooled.

Reports exact ``segments`` agreement, boundary F1 at tolerance 0, and the
largest ``hidden_states`` and ``segment_features`` differences; prints
"PARITY OK" (exact segments and hidden states within ``--tol``) or "PARITY
MISMATCH" and exits 1 on a mismatch. Writes
``<out-dir>/parity_vs_reference.json``:

    python -m sylber_tpu_torch.parity_vs_reference --ckpt sylber.ckpt \\
        [--wav tests/fixtures/speechlike.wav] [--tol 1e-3] [--num-hidden-layers 9]
        [--out-dir runs/parity_vs_reference]

It runs the port's side on ``cuda`` unless ``--device cpu`` is given, and
raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def ref_pipeline(ckpt, wav, norm_threshold, merge_threshold, layers=9):
    """The reference side on the CPU: ``(hidden states (L, d), segments
    (n, 2), segment features (n, d))``."""
    import os

    import torch

    os.environ.setdefault("USE_TF", "0")  # transformers' PyTorch models alone
    from transformers import HubertConfig, HubertModel

    from .ops.segment_np import segment_oracle

    model = HubertModel(HubertConfig(num_hidden_layers=layers)).eval()
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(sd, strict=False)
    with torch.no_grad():
        states = model(torch.from_numpy(wav[None])).last_hidden_state[0].numpy()
    segs = np.asarray(segment_oracle(states, norm_threshold, merge_threshold)).reshape(-1, 2)
    feats = (np.stack([states[s:e].mean(0) for s, e in segs])
             if len(segs) else np.zeros((0, states.shape[-1])))
    return states, segs, feats


def port_pipeline(ckpt, wav, norm_threshold, merge_threshold, device, layers=9):
    """The port's side: the ``Segmenter``'s output on ``wav`` unpadded."""
    from .api import Segmenter

    seg = Segmenter(model_ckpt=ckpt, encoding_layer=layers, precision="highest",
                    device=device, length_bucket_s=(len(wav) + 0.5) / 16000)
    return seg(wav=wav, in_second=False, norm_threshold=norm_threshold,
               merge_threshold=merge_threshold)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--wav", default=str(ROOT / "tests" / "fixtures" / "speechlike.wav"))
    ap.add_argument("--norm-threshold", type=float, default=2.6)
    ap.add_argument("--merge-threshold", type=float, default=0.8)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--num-hidden-layers", type=int, default=9,
                    help="the encoder layers on both sides (the checkpoint's first ones)")
    ap.add_argument("--out-dir", default="runs/parity_vs_reference")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def compare(args) -> Dict[str, Any]:
    """Both sides on ``args.wav``: the report ``main`` prints and writes."""
    from .api import resolve_device
    from .utils.audio import load_for_inference
    from .utils.metrics import boundary_f1

    device = resolve_device(args.device)
    wav = load_for_inference(args.wav)
    ref_states, ref_segs, ref_feats = ref_pipeline(
        args.ckpt, wav, args.norm_threshold, args.merge_threshold, args.num_hidden_layers)
    out = port_pipeline(args.ckpt, wav, args.norm_threshold, args.merge_threshold, device,
                        args.num_hidden_layers)

    exact = out["segments"].tolist() == ref_segs.tolist()
    h_err = float(np.abs(out["hidden_states"] - ref_states).max())
    f_err = (float(np.abs(out["segment_features"] - ref_feats).max())
             if exact and len(ref_segs) else float("nan"))
    return {"device": str(device), "wav": str(args.wav), "frames": int(len(ref_states)),
            "segments": int(len(ref_segs)), "segments_exact": exact,
            "boundary_f1_tol0": boundary_f1(out["segments"], ref_segs, tol_frames=0),
            "hidden_states_max_abs_delta": h_err, "segment_features_max_abs_delta": f_err,
            "tol": args.tol, "ok": bool(exact and h_err < args.tol)}


def main(argv=None) -> int:
    args = parse_args(argv)
    rep = compare(args)
    print(f"segments exact match: {rep['segments_exact']}")
    print(f"boundary F1 (tol 0 frames): {rep['boundary_f1_tol0']:.4f}")
    print(f"hidden_states max |delta|: {rep['hidden_states_max_abs_delta']:.3e}")
    print(f"segment_features max |delta|: {rep['segment_features_max_abs_delta']:.3e}")
    print("PARITY OK" if rep["ok"] else "PARITY MISMATCH")
    path = Path(args.out_dir) / "parity_vs_reference.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=2))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
