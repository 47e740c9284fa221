"""Host-side input pipeline: manifests, 5-s crops, noise clips, collation.

Port of ``sylber_tpu/data/dataset.py`` (numpy only; the batches are the JAX
package's for the same seed):

- tag-file manifests with per-corpus sampling ratios;
- WAV/FLAC load and resample to 16 kHz; a random ``max_len`` crop aligned
  to 320-sample frames, with a 160-sample zero buffer on both ends;
- precomputed segment ``.npy`` files, cropped and clipped to the window;
- a random noise clip at a random place;
- per-utterance zero-mean / unit-variance normalisation before padding
  ((x - mean) / sqrt(var + 1e-7), biased variance over the unpadded
  samples), or peak-scaled int16 PCM normalised later on the device;
- ``dummy_len`` fake epoch length under ratio sampling.

Batches are dicts of numpy arrays: input_values / attention_mask / noise
(B, max_len + 320) and segments (B, MS, 2) + num_segments (B,) with
MS = max_len / 320 + 1. :func:`step_batches` is the trainer's stream: the
indices and the random crops and noise of global step ``s`` depend on
``(seed, s)`` alone, so a resumed run sees the batches of an uninterrupted
one.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.audio import load_wav, resample

FRAME_SIZE = 320
BUFFER_SIZE = 160


def _zero_mean_unit_var(x: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor normalization (biased var, eps 1e-7)."""
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)


def load_manifest(files: Sequence[Tuple[float, str]]) -> List[Tuple[float, List[str]]]:
    """[(ratio, tag_file_path), ...] -> [(ratio, [tags...]), ...]."""
    out = []
    for ratio, path in files:
        with open(path) as f:
            tags = [t.rstrip() for t in f if t.strip()]
        out.append((float(ratio), tags))
    return out


class SpeechDataset:
    """Random-access sampler of cropped utterances (+ optional segments/noise)."""

    def __init__(
        self,
        wav_dirs: Sequence[str],
        tags: List[Tuple[float, List[str]]],
        data_dir: Optional[str] = None,
        max_len: int = 80_000,
        dummy_len: int = 300_000,
        sample_by_ratio: bool = True,
        noise_dir: Optional[str] = None,
        seed: int = 0,
    ):
        self.wav_dirs = [Path(d) for d in wav_dirs]
        self.data_dir = Path(data_dir) if data_dir else None
        if len(tags) == 1:
            sample_by_ratio = False
            self.flat_tags = tags[0][1]
        self.sample_by_ratio = sample_by_ratio
        if sample_by_ratio:
            ratios = np.array([r for r, _ in tags], np.float64)
            self.ratios = ratios / ratios.sum()
            self.tag_groups = [ts for _, ts in tags]
            self._len = dummy_len
        else:
            self.ratios = None
            self._len = len(self.flat_tags)
        self.max_len = max_len
        self.max_frames = max_len // FRAME_SIZE
        if noise_dir is not None:
            nd = Path(noise_dir)
            self.noise_files = sorted(nd.glob("*.wav")) + sorted(nd.glob("*.flac"))
        else:
            self.noise_files = None
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._len

    def _pick(self, i: int):
        if self.sample_by_ratio:
            di = self.rng.choice(len(self.ratios), p=self.ratios)
            group = self.tag_groups[di]
            tag = group[int(self.rng.uniform() * len(group)) % len(group)]
            return tag, self.wav_dirs[di]
        return self.flat_tags[i], self.wav_dirs[0]

    def _load_audio(self, wav_dir: Path, tag: str) -> np.ndarray:
        for ext in (".wav", ".flac", ".ogg"):
            p = wav_dir / f"{tag}{ext}"
            if p.exists():
                wav, sr = load_wav(p)
                return resample(wav, sr)[0]
        raise FileNotFoundError(f"{tag} under {wav_dir}")

    def __getitem__(self, i: int) -> Dict:
        tag, wav_dir = self._pick(i)
        wav = self._load_audio(wav_dir, tag)

        frame_len = len(wav) // FRAME_SIZE
        wav = wav[: frame_len * FRAME_SIZE]
        if frame_len > self.max_frames:
            offset = self.rng.randint(frame_len - self.max_frames)
            wav = wav[offset * FRAME_SIZE: offset * FRAME_SIZE + self.max_len]
            s, e = offset, offset + self.max_frames
        else:
            s, e = 0, self.max_frames
        wav = np.concatenate([
            np.zeros(BUFFER_SIZE, wav.dtype), wav, np.zeros(BUFFER_SIZE, wav.dtype)
        ])

        segments = None
        if self.data_dir is not None:
            raw = np.load(self.data_dir / f"{tag}.npy")
            keep = []
            for s_, e_ in raw:
                if min(e_, e) - max(s_, s) > 0:
                    keep.append([s_ - s, e_ - s])
            segments = (np.array(keep, np.int64).clip(0, self.max_frames)
                        if keep else np.zeros((0, 2), np.int64))

        noise = None
        if self.noise_files:
            nf = self.noise_files[int(self.rng.uniform() * len(self.noise_files))
                                  % len(self.noise_files)]
            nwav, nsr = load_wav(nf)
            nwav = resample(nwav, nsr)[0]
            if len(nwav) > len(wav):
                p = int(self.rng.uniform() * (len(nwav) - len(wav)))
                nwav = nwav[p: p + len(wav)]
            wp = int(max(0.0, self.rng.uniform() * (len(wav) - len(nwav))))
            noise = np.zeros_like(wav)
            noise[wp: wp + len(nwav)] = nwav

        return {"wav": wav, "segments": segments, "noise": noise, "tag": tag,
                "range": (s, e)}

    def collate(self, items: List[Dict],
                transfer: str = "float32") -> Dict[str, np.ndarray]:
        """Build a padded batch.

        ``transfer="int16"`` ships waveforms as peak-scaled int16 PCM and the
        mask as int8, deferring the per-item zero-mean/unit-var normalization
        to the device (the train step and the inference program both handle
        int16 inputs): 2.6x fewer host->device bytes — the training loop's
        throughput limiter on bandwidth-constrained links, and less PCIe
        traffic on real hosts. Per-item peak scaling is erased by the
        normalization, so the two modes are equivalent up to int16
        quantization (~1e-4 relative).
        """
        B = len(items)
        max_l = max(len(it["wav"]) for it in items)
        int16 = transfer == "int16"
        input_values = np.zeros((B, max_l), np.int16 if int16 else np.float32)
        attention_mask = np.zeros((B, max_l),
                                  np.int8 if int16 else np.int32)
        for i, it in enumerate(items):
            if int16:
                w = it["wav"]
                peak = max(np.abs(w).max(), 1e-9)
                input_values[i, : len(w)] = np.clip(
                    w * (32767.0 / peak), -32767, 32767).astype(np.int16)
            else:
                w = _zero_mean_unit_var(it["wav"])
                input_values[i, : len(w)] = w
            attention_mask[i, : len(it["wav"])] = 1
        batch = {"input_values": input_values, "attention_mask": attention_mask}

        if items[0]["segments"] is not None:
            MS = self.max_frames + 1
            segs = np.zeros((B, MS, 2), np.int32)
            counts = np.zeros((B,), np.int32)
            for i, it in enumerate(items):
                k = min(len(it["segments"]), MS)
                segs[i, :k] = it["segments"][:k]
                counts[i] = k
            batch["segments"] = segs
            batch["num_segments"] = counts
        else:
            batch["segments"] = None

        if items[0]["noise"] is not None:
            if transfer == "int16":
                noise = np.zeros((B, max_l), np.int16)
                for i, it in enumerate(items):
                    n = it["noise"]
                    peak = max(np.abs(n).max(), 1e-9)
                    noise[i, : len(n)] = np.clip(
                        n * (32767.0 / peak), -32767, 32767).astype(np.int16)
            else:
                noise = np.zeros((B, max_l), np.float32)
                for i, it in enumerate(items):
                    n = _zero_mean_unit_var(it["noise"]) \
                        if it["noise"].std() > 0 \
                        else it["noise"].astype(np.float32)
                    noise[i, : len(n)] = n
            batch["noise"] = noise
        return batch

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True,
                transfer: str = "float32",
                workers: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of collated batches.

        ``workers > 0`` assembles batches in that many worker processes
        (decode, crop, noise and collate off the main process). Each batch's
        RNG is then seeded from ``(self.seed, batch_index)``, so the stream is
        deterministic and does not depend on the worker count (it differs
        from the single-process stream, which threads one RNG through the
        epoch).
        """
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        starts = []
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            if i + batch_size > len(order) and drop_last:
                break
            starts.append(i)
        if workers:
            yield from _mp_batches(
                self, ((b, order[i: i + batch_size]) for b, i in enumerate(starts)),
                transfer, workers)
            return
        for i in starts:
            idx = order[i: i + batch_size]
            yield self.collate([self[j] for j in idx], transfer=transfer)


def batch_rng(seed: int, b: int) -> np.random.RandomState:
    """The RNG of batch ``b`` in a stream seeded ``seed``."""
    return np.random.RandomState((1_000_003 * (seed + 1) + b) % (2 ** 31))


def _assemble(ds, b: int, idx, transfer: str) -> Dict[str, np.ndarray]:
    ds.rng = batch_rng(getattr(ds, "seed", 0), b)
    return ds.collate([ds[j] for j in idx], transfer=transfer)


def _mp_worker(ds, transfer: str, task_q, out_q) -> None:
    """Worker-process loop for :func:`_mp_batches` (module level, so a
    spawned process can import it)."""
    while True:
        task = task_q.get()
        if task is None:
            return
        b, idx = task
        out_q.put((b, _assemble(ds, b, idx, transfer)))


def _mp_batches(ds, tasks: Iterable[Tuple[int, np.ndarray]], transfer: str,
                workers: int) -> Iterator[Dict[str, np.ndarray]]:
    """Process-pool batch assembly: each task ``(b, indices)`` is one whole
    batch, built with the RNG of :func:`batch_rng` ``(ds.seed, b)``; batches
    come out in task order, whatever order the workers finish in. At most
    ``2 * workers`` tasks are in flight, so ``tasks`` may be endless.

    Workers are spawned (a fork of a process whose threads hold locks, as
    torch's do, can deadlock the child); the dataset is pickled to each."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    task_q, out_q = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_mp_worker, args=(ds, transfer, task_q, out_q),
                         daemon=True) for _ in range(workers)]
    for p in procs:
        p.start()
    tasks = iter(tasks)
    order: List[int] = []
    pending: Dict[int, Dict] = {}
    try:
        while True:
            while len(order) < 2 * workers:
                task = next(tasks, None)
                if task is None:
                    break
                task_q.put(task)
                order.append(task[0])
            if not order:
                return
            want = order.pop(0)
            while want not in pending:
                b, batch = out_q.get()
                pending[b] = batch
            yield pending.pop(want)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join()


def step_batches(ds, batch_size: int, seed: int, start: int = 0,
                 transfer: str = "float32", workers: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """The trainer's endless stream from global step ``start`` on: the
    indices of step ``s`` are batch ``s`` of :func:`index_stream` ``(seed)``
    and its crops and noise come from :func:`batch_rng` ``(seed, s)``."""
    from .device import index_stream

    tasks = ((start + k, idx) for k, idx in enumerate(
        index_stream(len(ds), batch_size, shuffle=True, seed=seed, start=start)))
    if workers:
        yield from _mp_batches(ds, tasks, transfer, workers)
        return
    for b, idx in tasks:
        yield _assemble(ds, b, idx, transfer)


def prefetch(it: Iterator, depth: int = 2, transform=None) -> Iterator:
    """Background-thread prefetch: the thread takes items from ``it`` and
    runs ``transform`` on them (the copy to the device, so that it overlaps
    the previous step), ``depth`` items ahead of the consumer. An exception
    in the thread is raised to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list = []

    def worker():
        try:
            for item in it:
                q.put(transform(item) if transform is not None else item)
        except BaseException as e:  # handed to the consumer, which raises it
            error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item


class SyntheticSpeechDataset(SpeechDataset):
    """In-memory synthetic-speech corpus (no audio on disk).

    Utterances come from :mod:`sylber_tpu_torch.data.synthetic` — syllabic audio
    with analytically known boundaries — so smoke/e2e training runs can learn
    and be scored against real ground truth (segments are the true syllable
    spans, not random frames). Used by tests, the mini end-to-end training
    proof, and the precision-agreement gates.
    """

    def __init__(self, n_utts: int = 32, max_len: int = 80_000,
                 with_segments: bool = True, with_noise: bool = True,
                 seed: int = 0, utt_seconds: Tuple[float, float] = (2.0, 8.0),
                 style: str = "v1"):
        self.style = style
        self.max_len = max_len
        self.max_frames = max_len // FRAME_SIZE
        self.rng = np.random.RandomState(seed)
        self.seed = seed
        self._len = n_utts
        self.sample_by_ratio = False
        self.with_segments = with_segments
        self.with_noise = with_noise
        self.data_dir = "synthetic" if with_segments else None
        self.noise_files = ["synthetic"] if with_noise else None
        self.utt_seconds = utt_seconds
        # items are deterministic per index; cache them so that later
        # epochs and the prefetch thread do not synthesise them again
        self._cache: Dict[int, Dict] = {}

    def __getitem__(self, i: int) -> Dict:
        from .synthetic import synth_utterance

        if i in self._cache:
            return self._cache[i]
        rng = np.random.RandomState((hash((i, 1337)) ^ self.seed) % (2 ** 31))
        n = int(rng.uniform(*self.utt_seconds) * 16000)
        wav, true_segs = synth_utterance(rng, n, style=self.style)

        frame_len = len(wav) // FRAME_SIZE
        wav = wav[: frame_len * FRAME_SIZE]
        s = 0
        if frame_len > self.max_frames:
            s = rng.randint(frame_len - self.max_frames)
            wav = wav[s * FRAME_SIZE: s * FRAME_SIZE + self.max_len]
            frame_len = self.max_frames
        e = s + frame_len
        wav = np.concatenate([np.zeros(BUFFER_SIZE, np.float32), wav,
                              np.zeros(BUFFER_SIZE, np.float32)])

        segments = None
        if self.with_segments:
            # crop/clip the true spans to the window (reference semantics,
            # collective_audio_segment.py:88-95)
            keep = []
            for s_, e_ in true_segs:
                if min(e_, e) - max(s_, s) > 0:
                    keep.append([s_ - s, e_ - s])
            segments = (np.array(keep, np.int64).clip(0, self.max_frames)
                        if keep else np.zeros((0, 2), np.int64))
        noise = rng.randn(len(wav)).astype(np.float32) * 0.1 \
            if self.with_noise else None
        item = {"wav": wav, "segments": segments, "noise": noise,
                "tag": f"synt{i}", "range": (s, e)}
        self._cache[i] = item
        return item
