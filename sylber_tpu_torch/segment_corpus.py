"""Batch-segment a corpus: the LibriSpeech-style throughput and eval runner.

Port of ``scripts/segment_corpus.py``. Walks a directory (or a manifest) of
WAV, FLAC and OGG files, loads them all first, sorts them by length and
runs them in batches through the ``Segmenter`` (bf16 with a bf16 frontend by
default, 4 s length buckets). One untimed warm-up call goes to each distinct
(padded length, batch) bucket, so cuDNN's plans and the kernels' build stay
out of the timed loop. Writes per-utterance segments in seconds and prints
the corpus's stats as one JSON line: RTFx over the timed loop, a steady
RTFx without outlier batches, and the token rate (the reference reports
4.27 tokens a second); with ``--compare``, the boundary F1 against another
run's ``.npz``. Loading is set-up: its time goes to stderr, apart from the
timed window.

Usage:
  python -m sylber_tpu_torch.segment_corpus --audio-dir test-clean/ --out r.npz \\
      [--ckpt model.npz] [--model-config mini_ckpt.json] [--batch-size 32] \\
      [--dtype bfloat16] [--precision default] [--compare other.npz] [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. Beside the JAX runner's flags: ``--device``; ``--model-config``, a JSON
file whose ``hubert`` object and ``encoding_layer`` give the encoder's widths
and depth (as the mini fixtures' ``.json`` files do; HuBERT base, 9 layers,
by default); ``--precision`` (the JAX runner's is always "default").
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

AUDIO_EXTS = (".wav", ".flac", ".ogg")
SAMPLE_RATE = 16000


def tag_path(wav_dir, tag: str) -> Path:
    """``<wav_dir>/<tag>`` with the first of ``AUDIO_EXTS`` that exists."""
    for ext in AUDIO_EXTS:
        path = Path(wav_dir) / f"{tag}{ext}"
        if path.exists():
            return path
    raise FileNotFoundError(tag)


def find_audio(audio_dir: Optional[str] = None, manifest: Optional[str] = None,
               wav_dir: Optional[str] = None):
    """The corpus's files and their names: every ``*.wav``, ``*.flac`` and
    ``*.ogg`` under ``audio_dir`` (names relative to it), or each tag of
    ``manifest`` found in ``wav_dir`` with the first of those extensions."""
    if audio_dir:
        files = [f for ext in AUDIO_EXTS for f in sorted(Path(audio_dir).rglob(f"*{ext}"))]
        names = [str(f.relative_to(audio_dir)) for f in files]
    else:
        if not (manifest and wav_dir):
            raise ValueError("pass --audio-dir, or --manifest with --wav-dir")
        names = [t.strip() for t in open(manifest) if t.strip()]
        files = [tag_path(wav_dir, t) for t in names]
    if not files:
        raise FileNotFoundError("no audio found")
    return files, names


def model_widths(path: Optional[str]) -> Dict[str, Any]:
    """``HubertConfig`` fields from a JSON file's ``hubert`` object and
    ``encoding_layer`` (none: HuBERT base, 9 layers)."""
    if path is None:
        return {}
    meta = json.loads(Path(path).read_text())
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta.get("hubert", {}).items()}
    widths["num_hidden_layers"] = meta.get("encoding_layer", 9)
    return widths


def segmenter_config(dtype: str = "bfloat16", precision: str = "default",
                     widths: Optional[Dict[str, Any]] = None):
    """The runner's encoder: ``dtype`` with a frontend of the same dtype."""
    from .models.hubert import HubertConfig

    return HubertConfig(dtype=dtype, frontend_dtype=dtype, precision=precision,
                        **(widths or {}))


def load_corpus(files: Sequence[Path]) -> List[np.ndarray]:
    """Each file loaded, resampled to 16 kHz and normalised: (L,) float32."""
    from .utils.audio import load_for_inference

    return [load_for_inference(f) for f in files]


def plan_batches(wavs: Sequence[np.ndarray], batch_size: int) -> List[np.ndarray]:
    """Indices of ``wavs`` longest first, cut into batches."""
    order = np.argsort([-len(w) for w in wavs], kind="stable")
    return [order[i: i + batch_size] for i in range(0, len(order), batch_size)]


def warm_up(seg, wavs: Sequence[np.ndarray], planned: Sequence[np.ndarray]) -> int:
    """One untimed call a distinct (padded length, batch size) bucket."""
    seen = set()
    lb = seg.length_bucket
    for idx in planned:
        key = (-(-max(len(wavs[j]) for j in idx) // lb) * lb, len(idx))
        if key not in seen:
            seen.add(key)
            seg.process([wavs[j] for j in idx], in_second=True, return_hidden=False)
    return len(seen)


def run_batches(seg, wavs: Sequence[np.ndarray], planned: Sequence[np.ndarray],
                batch_hook: Optional[Callable[[int], Any]] = None):
    """The timed loop: ``(segments in seconds by index, [(audio s, wall s)
    a batch], wall s)``. ``batch_hook(i)``, if given, returns a context
    manager entered around batch ``i`` (a caller's counters)."""
    results: Dict[int, np.ndarray] = {}
    batch_walls = []
    t0 = time.perf_counter()
    for bi, idx in enumerate(planned):
        with batch_hook(bi) if batch_hook else nullcontext():
            tb = time.perf_counter()
            outs = seg.process([wavs[j] for j in idx], in_second=True, return_hidden=False)
            batch_walls.append((sum(len(wavs[j]) for j in idx) / SAMPLE_RATE,
                                time.perf_counter() - tb))
        for j, o in zip(idx, outs):
            results[int(j)] = o["segments"]
        if bi % 50 == 49:
            gc.collect()  # long loops gather cyclic host garbage faster than the GC runs
    return results, batch_walls, time.perf_counter() - t0


def corpus_stats(segments: Sequence[np.ndarray], wavs: Sequence[np.ndarray],
                 batch_walls, wall: float) -> Dict[str, Any]:
    """The JAX runner's stats: RTFx over the timed loop, the steady RTFx
    without the batches above 5x the median batch's wall, the token rate."""
    from .utils.metrics import token_rate

    total_seconds = sum(len(w) for w in wavs) / SAMPLE_RATE
    med = float(np.median([w for _, w in batch_walls]))
    steady = [(a, w) for a, w in batch_walls if w <= 5 * med]
    return {
        "utts": len(wavs),
        "audio_seconds": total_seconds,
        "wall_seconds": wall,
        "rtfx": total_seconds / wall,
        "rtfx_steady": sum(a for a, _ in steady) / max(sum(w for _, w in steady), 1e-9),
        "n_compile_outlier_batches": len(batch_walls) - len(steady),
        "token_rate": token_rate(list(segments), [len(w) / SAMPLE_RATE for w in wavs]),
    }


def compare(results: Dict[str, np.ndarray], other_path: str) -> Dict[str, Any]:
    """Mean boundary F1 at tolerance 0 (50 Hz frames) against another run's
    ``.npz``, over the names both hold."""
    from .utils.metrics import boundary_f1

    other = np.load(other_path, allow_pickle=True)
    f1s = [boundary_f1((results[k] * 50).astype(int), (other[k] * 50).astype(int),
                       tol_frames=0)
           for k in results if k in other]
    return {"boundary_f1_vs_compare": float(np.mean(f1s)), "n_compared": len(f1s)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--audio-dir", default=None)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--wav-dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="what Segmenter(model_ckpt=...) takes: a JAX-layout .npz or a "
                         "PyTorch state dict; none: seeded random weights")
    ap.add_argument("--model-config", default=None,
                    help="JSON file whose 'hubert' object and 'encoding_layer' give the "
                         "encoder's widths (e.g. tests/fixtures/mini_ckpt.json)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--norm-threshold", type=float, default=2.6)
    ap.add_argument("--merge-threshold", type=float, default=0.8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--precision", default="default", choices=["default", "highest"])
    ap.add_argument("--compare", default=None,
                    help="npz of another run; reports boundary F1 vs it")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed per-bucket warm-up pass")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None, batch_hook: Optional[Callable[[int], Any]] = None) -> Dict[str, Any]:
    """Run the corpus; return the stats, the segments in seconds by name,
    the load time and, with ``--compare``, the comparison."""
    args = parse_args(argv)
    from .api import Segmenter

    seg = Segmenter(model_ckpt=args.ckpt,
                    hubert_config=segmenter_config(args.dtype, args.precision,
                                                   model_widths(args.model_config)),
                    norm_threshold=args.norm_threshold,
                    merge_threshold=args.merge_threshold,
                    length_bucket_s=4.0, device=args.device)
    files, names = find_audio(args.audio_dir, args.manifest, args.wav_dir)

    t_load = time.perf_counter()
    wavs = load_corpus(files)
    load_seconds = time.perf_counter() - t_load
    print(f"loaded {len(wavs)} files ({sum(map(len, wavs)) / SAMPLE_RATE:.1f} s of audio) "
          f"in {load_seconds:.3f} s, outside the timed window", file=sys.stderr)
    planned = plan_batches(wavs, args.batch_size)
    if not args.no_warmup:
        print(f"warmed {warm_up(seg, wavs, planned)} bucket shapes", file=sys.stderr)

    by_index, batch_walls, wall = run_batches(seg, wavs, planned, batch_hook)
    results = {names[j]: by_index[j] for j in range(len(names))}
    stats = corpus_stats([by_index[j] for j in range(len(names))], wavs, batch_walls, wall)
    np.savez(args.out, stats=json.dumps(stats), **results)
    print(json.dumps(stats))
    out = dict(stats=stats, results=results, load_seconds=load_seconds,
               batch_walls=batch_walls)
    if args.compare:
        out["compare"] = compare(results, args.compare)
        print(json.dumps(out["compare"]))
    return out


if __name__ == "__main__":
    main()
