"""Precompute the per-utterance segment ``.npy`` files of stage-1 training.

Port of ``scripts/precompute_segments.py``. The reference's stage-1 recipe
reads SDHuBERT-derived segments as ``<data_dir>/<tag>.npy`` but ships no tool
to make them. This runs an encoder checkpoint over a manifest of tags, in
batches on the device, and writes each tag's int64 frame segments
(``[start, end)`` at 50 Hz); the segmentation runs on the device. With
``--native`` the hidden states are segmented again on the host by the C++
segmenter (``utils/native.py::segment_native``), whose files then serve as
an independent check of the device's.

Usage:
  python -m sylber_tpu_torch.precompute_segments --manifest tags.txt \\
      --wav-dir /data/wavs --out-dir /data/segments [--ckpt model.npz] \\
      [--norm-threshold 2.6] [--merge-threshold 0.8] [--native] [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. Beside the JAX script's flags: ``--device``, ``--model-config`` (the
encoder's widths, as in ``segment_corpus``), and ``--dtype``,
``--precision`` and ``--length-bucket-s`` (the JAX script always runs the
``Segmenter``'s defaults: fp32, "highest", 1 s buckets, which stay the
defaults here). The GroupNorm of the encoder's first layer takes its moments
over the padded length, so two runs give the same segments only with the
same buckets and the same batches.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .segment_corpus import model_widths, segmenter_config, tag_path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--model-config", default=None,
                    help="JSON file whose 'hubert' object and 'encoding_layer' give the "
                         "encoder's widths (e.g. tests/fixtures/mini_ckpt.json)")
    ap.add_argument("--norm-threshold", type=float, default=2.6)
    ap.add_argument("--merge-threshold", type=float, default=0.8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--precision", default="highest", choices=["default", "highest"])
    ap.add_argument("--length-bucket-s", type=float, default=1.0)
    ap.add_argument("--native", action="store_true",
                    help="segment on the host with the C++ implementation")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Write ``<out-dir>/<tag>.npy`` for every tag; return how many."""
    args = parse_args(argv)
    from .api import Segmenter
    from .utils.audio import load_for_inference

    seg = Segmenter(model_ckpt=args.ckpt,
                    hubert_config=segmenter_config(args.dtype, args.precision,
                                                   model_widths(args.model_config)),
                    length_bucket_s=args.length_bucket_s, device=args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tags = [t.strip() for t in open(args.manifest) if t.strip()]
    native = None
    if args.native:
        from .utils.native import segment_native

        native = segment_native

    done = 0
    for i in range(0, len(tags), args.batch_size):
        chunk = tags[i: i + args.batch_size]
        wavs = [load_for_inference(tag_path(args.wav_dir, t)) for t in chunk]
        outs = seg.process(wavs, in_second=False, norm_threshold=args.norm_threshold,
                           merge_threshold=args.merge_threshold,
                           return_hidden=native is not None)
        for t, o in zip(chunk, outs):
            segs = (native(o["hidden_states"], args.norm_threshold, args.merge_threshold)
                    if native is not None else o["segments"])
            np.save(out_dir / f"{t}.npy", np.asarray(segs, np.int64))
        done += len(chunk)
        print(f"\r{done}/{len(tags)}", end="", flush=True)
    print("\ndone")
    return done


if __name__ == "__main__":
    main()
