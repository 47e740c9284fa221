"""Micro-batching server around :class:`~sylber_tpu_torch.api.Segmenter`.

Port of ``sylber_tpu/serve.py``. The card segments a batch of utterances in
little more time than one, so throughput comes from coalescing concurrent
requests into batches:

- callers ``submit(wav)`` from any thread and get a
  ``concurrent.futures.Future``;
- one dispatcher thread drains the queue, groups compatible requests (same
  thresholds and options), takes the longest first so one padded batch
  covers them, and runs one ``Segmenter.process_async`` call per batch; it
  issues all device work;
- results go back to each request's future; a failed batch fails only its
  own requests, and the server keeps serving.

Batching policy: the dispatcher waits at most ``max_wait_ms`` after the
first queued request for a batch to fill, so at low load a request waits at
most that plus one batch, and at high load batches are full and the wait
never triggers.

With ``pipeline_depth > 0`` a finalizer thread runs each batch's
``finalize`` (the copies to the host) while the dispatcher enqueues the
next batch. Both use the device's current stream, so a batch's copies queue
behind the forward enqueued after it: the overlap is of host work only.

The HTTP front end is ``python -m sylber_tpu_torch.serve_http``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class _Request:
    wav: np.ndarray
    future: Future
    key: tuple  # (norm_threshold, merge_threshold, in_second, return_hidden)
    t_enqueue: float


@dataclass
class ServerStats:
    """Snapshot of serving counters (cumulative since start)."""

    requests: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    batched_items: int = 0
    queue_depth: int = 0
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    latency_mean_ms: float = 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.batched_items / self.batches if self.batches else 0.0


class SegmenterServer:
    """Micro-batching request server around a :class:`Segmenter`.

    Args:
      segmenter: the (already constructed) Segmenter; the server never
        mutates it and issues all device work from one dispatcher thread.
      max_batch: largest batch handed to ``Segmenter.process`` (clamped to
        the segmenter's largest batch bucket, so a batch is one forward).
      max_wait_ms: deadline after the first request of a batch before
        dispatching a partial batch.
      max_queue: backpressure bound; ``submit`` raises ``queue.Full`` beyond
        it rather than buffering unboundedly.
      pipeline_depth: >0 runs batch N's ``finalize`` (the copies to the
        host) on a finalizer thread while batch N+1 is uploaded and
        enqueued; at most this many batches wait for it. Default 0
        (``finalize`` inline on the dispatcher).
    """

    def __init__(
        self,
        segmenter,
        max_batch: int = 32,
        max_wait_ms: float = 10.0,
        max_queue: int = 4096,
        pipeline_depth: int = 0,
    ) -> None:
        self.segmenter = segmenter
        cap = max(getattr(segmenter, "batch_buckets", (max_batch,)))
        self.max_batch = min(int(max_batch), int(cap))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        # _pending is mutated only by the dispatcher thread, but stats()
        # iterates it from caller threads — every mutation and the stats
        # read hold _lock (mutations are tiny: list append / dict del).
        self._pending: Dict[tuple, List[_Request]] = {}
        self._lock = threading.Lock()
        # serializes the submit-time stopped-check+enqueue against stop()
        # setting _stopped: any request enqueued under this lock is in _q
        # before _stopped is set, so the dispatcher's exit drain sees it
        # (otherwise a late submit's Future would never resolve).
        self._submit_lock = threading.Lock()
        self._stats = ServerStats()
        self._lat_ms: List[float] = []  # ring buffer of recent latencies
        self._stopped = threading.Event()
        # pipeline_depth > 0: dispatch batch N+1 while a finalizer thread
        # runs batch N's copies to the host. They share the device's stream,
        # so those copies wait behind batch N+1's forward (head-of-line
        # blocking); chip_smoke.py measures depth 0 against depth 1.
        self.pipeline_depth = int(pipeline_depth)
        self._fq: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.pipeline_depth))
        self._finalizer = None
        if self.pipeline_depth > 0:
            self._finalizer = threading.Thread(
                target=self._finalize_loop, name="sylber-serve-finalize",
                daemon=True)
            self._finalizer.start()
        self._thread = threading.Thread(
            target=self._run, name="sylber-serve", daemon=True
        )
        self._thread.start()

    # ---- client surface -------------------------------------------------

    def submit(
        self,
        wav: np.ndarray,
        in_second: bool = True,
        norm_threshold: Optional[float] = None,
        merge_threshold: Optional[float] = None,
        return_hidden: bool = False,
    ) -> Future:
        """Enqueue one utterance; returns a Future resolving to the
        Segmenter output dict. ``return_hidden`` defaults to False for
        serving: the hidden states are 50 frames x d floats a second of
        audio to copy to the host."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if wav.size < 400:  # below one receptive field -> zero frames
            raise ValueError(
                f"utterance too short: {wav.size} samples < 400 (25 ms)")
        fut: Future = Future()
        key = (norm_threshold, merge_threshold, bool(in_second),
               bool(return_hidden))
        with self._submit_lock:
            if self._stopped.is_set():
                raise RuntimeError("SegmenterServer is stopped")
            self._q.put(_Request(wav, fut, key, time.monotonic()))
        with self._lock:
            self._stats.requests += 1
        return fut

    def segment(self, wav: np.ndarray, **kw) -> Dict[str, Any]:
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(wav, **kw).result()

    def submit_many(self, wavs: Sequence[np.ndarray], **kw) -> List[Future]:
        return [self.submit(w, **kw) for w in wavs]

    def warmup(
        self,
        lengths_s: Sequence[float] = (2.0, 4.0, 8.0),
        batch_sizes: Optional[Sequence[int]] = None,
    ) -> None:
        """Run each (batch, length) bucket once before serving: the first
        call builds the CUDA kernels and picks the cuDNN algorithms."""
        bbs = batch_sizes or [b for b in self.segmenter.batch_buckets
                              if b <= self.max_batch]
        for sec in lengths_s:
            n = int(sec * 16000)
            wav = np.zeros(n, np.float32)
            wav[:: 160] = 1.0  # non-degenerate input
            for b in bbs:
                self.segmenter.process([wav] * b, return_hidden=False)

    def stats(self) -> ServerStats:
        with self._lock:
            s = ServerStats(**{k: getattr(self._stats, k)
                               for k in self._stats.__dataclass_fields__})
            s.queue_depth = self._q.qsize() + sum(
                len(v) for v in self._pending.values())
            lat = sorted(self._lat_ms)
            if lat:
                s.latency_p50_ms = lat[len(lat) // 2]
                s.latency_p95_ms = lat[min(len(lat) - 1,
                                           int(len(lat) * 0.95))]
                s.latency_mean_ms = sum(lat) / len(lat)
            return s

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the dispatcher. ``drain=True`` serves queued requests first;
        ``drain=False`` cancels anything not yet dispatched."""
        with self._submit_lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
        self._drain_on_stop = drain
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=timeout)
        if self._finalizer is not None:
            # the dispatcher enqueues the finalizer sentinel itself as its
            # last act (_run), so a timed-out join above cannot let the
            # sentinel overtake still-to-be-enqueued batches (which would
            # kill the finalizer early and deadlock the dispatcher on the
            # bounded queue)
            self._finalizer.join(timeout=timeout)

    def __enter__(self) -> "SegmenterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- dispatcher -----------------------------------------------------

    def _take(self, block: bool, deadline: Optional[float]) -> bool:
        """Move one queue item into the pending map. Returns False on
        sentinel/timeout."""
        try:
            if block:
                timeout = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                req = self._q.get(timeout=timeout) if deadline is not None \
                    else self._q.get()
            else:
                req = self._q.get_nowait()
        except queue.Empty:
            return False
        if req is None:
            return False
        with self._lock:
            self._pending.setdefault(req.key, []).append(req)
        return True

    def _next_batch(self) -> Optional[List[_Request]]:
        """Pick the fullest compatible group; take up to max_batch requests,
        longest first (so one padded batch covers them with the least padding)."""
        with self._lock:
            if not self._pending:
                return None
            key = max(self._pending, key=lambda k: len(self._pending[k]))
            group = self._pending[key]
            group.sort(key=lambda r: len(r.wav), reverse=True)
            batch, rest = group[: self.max_batch], group[self.max_batch:]
            if rest:
                self._pending[key] = rest
            else:
                del self._pending[key]
            return batch

    def _run(self) -> None:
        while True:
            if not self._pending:
                # idle: block for the first request of the next batch
                got = self._take(block=True, deadline=None)
                if not got and self._stopped.is_set():
                    break
                if not got:
                    continue
            # batch-fill window: gather until max_batch or deadline
            deadline = time.monotonic() + self.max_wait_s
            while sum(len(v) for v in self._pending.values()) < self.max_batch:
                if not self._take(block=True, deadline=deadline):
                    break
            batch = self._next_batch()
            if batch:
                self._dispatch(batch)
            if self._stopped.is_set() and self._q.qsize() == 0 \
                    and not self._pending:
                break
        # stopped: resolve anything left
        with self._lock:
            leftover = [r for g in self._pending.values() for r in g]
            self._pending.clear()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                leftover.append(req)
        if leftover and getattr(self, "_drain_on_stop", True):
            for i in range(0, len(leftover), self.max_batch):
                self._dispatch(leftover[i: i + self.max_batch])
        else:
            for r in leftover:
                r.future.cancel()
        if self._finalizer is not None:
            # last act of the dispatcher: every batch is now enqueued, so
            # the sentinel cannot overtake work (see stop())
            self._fq.put(None)

    def _dispatch(self, batch: List[_Request]) -> None:
        """Upload and enqueue the batch, then hand the (batch, finalize) pair
        to the finalizer thread (pipeline mode) or finalize inline (default).
        In pipeline mode up to pipeline_depth batches queue behind the one
        being finalized; each holds its device outputs, so the depth bounds
        the device memory held by results in flight."""
        nt, mt, in_second, return_hidden = batch[0].key
        kw = dict(in_second=in_second, norm_threshold=nt,
                  merge_threshold=mt, return_hidden=return_hidden)
        wavs = [r.wav for r in batch]
        try:
            if hasattr(self.segmenter, "process_async"):
                finalize = self.segmenter.process_async(wavs, **kw)
            else:  # plain .process segmenters (test fakes) run entirely
                # in finalize; dispatch order and batch composition are
                # decided here either way
                finalize = (lambda s=self.segmenter, w=wavs, k=kw:
                            s.process(w, **k))
        except Exception as e:  # fail this batch only; keep serving
            self._fail(batch, e)
            return
        if self._finalizer is None:
            self._complete(batch, finalize)
        else:
            self._fq.put((batch, finalize))

    def _fail(self, batch: List[_Request], e: Exception) -> None:
        with self._lock:
            self._stats.failed += len(batch)
        for r in batch:
            if not r.future.cancelled():
                r.future.set_exception(e)

    def _finalize_loop(self) -> None:
        while True:
            item = self._fq.get()
            if item is None:
                break
            self._complete(*item)

    def _complete(self, batch: List[_Request], finalize) -> None:
        try:
            outs = finalize()
        except Exception as e:
            self._fail(batch, e)
            return
        now = time.monotonic()
        with self._lock:
            self._stats.batches += 1
            self._stats.batched_items += len(batch)
            self._stats.completed += len(batch)
            for r in batch:
                self._lat_ms.append((now - r.t_enqueue) * 1e3)
            if len(self._lat_ms) > 2048:
                self._lat_ms = self._lat_ms[-1024:]
        for r, out in zip(batch, outs):
            if not r.future.cancelled():
                r.future.set_result(out)
