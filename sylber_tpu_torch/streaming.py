"""Streaming syllable segmentation with bounded latency.

Port of ``sylber_tpu/streaming.py``. Audio arrives in chunks of any size;
every ``hop_seconds`` the most recent ``window_seconds`` of audio (aligned to
the frame grid, so window frames map exactly onto global frames) goes
through ``Segmenter.process`` as a batch of one. Segments that end at least
``commit_guard_seconds`` before the stream head are committed: emitted
exactly once, in order. The guard keeps boundaries that may still move with
more right context out of the committed set. Latency is hop + guard
(1.5 s by default), plus one window's inference.

The encoder is not causal, so a committed boundary can differ from the one
an offline pass over the whole recording finds when its left context is
longer than the window.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .api import FRAME_RATE, Segmenter

FRAME = 320


class StreamingSegmenter:
    """Runs on the device of the ``Segmenter`` it wraps."""

    def __init__(self, segmenter: Segmenter, window_seconds: float = 4.0,
                 hop_seconds: float = 1.0, commit_guard_seconds: float = 0.5) -> None:
        self.segmenter = segmenter
        self.window = int(window_seconds * 16000) // FRAME * FRAME
        self.hop = int(hop_seconds * 16000) // FRAME * FRAME
        self.guard_frames = int(commit_guard_seconds * FRAME_RATE)
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros((0,), np.float32)
        self._total = 0            # samples seen
        self._processed = 0        # samples consumed by inference calls
        self._commit_frame = 0     # frames emitted so far (exclusive)

    def push(self, samples: np.ndarray, in_second: bool = True, **thresholds) -> List:
        """Feed audio; returns the newly committed segments."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        self._total += len(samples)
        out: List = []
        while self._total - self._processed >= self.hop:
            self._processed += self.hop
            out.extend(self._infer(final=False, in_second=in_second, **thresholds))
        return out

    def flush(self, in_second: bool = True, **thresholds) -> List:
        """End of stream: commit everything."""
        out = self._infer(final=True, in_second=in_second, **thresholds)
        self.reset()
        return out

    def _infer(self, final: bool, in_second: bool, **thresholds) -> List:
        # window start on the global frame grid, covering the stream head
        head = self._total if final else self._processed
        start = max(0, head - self.window)
        start = (start // FRAME) * FRAME
        chunk = self._buf[len(self._buf) - (self._total - start):]
        if len(chunk) < FRAME + 80:
            return []
        res = self.segmenter.process([chunk], in_second=False, return_hidden=False,
                                     **thresholds)[0]
        offset = start // FRAME
        segs = np.asarray(res["segments"], np.int64).reshape(-1, 2) + offset

        head_frame = head // FRAME
        commit_until = head_frame if final else head_frame - self.guard_frames
        out = []
        for s, e in segs:
            if e > commit_until:
                break
            if s < self._commit_frame:
                s = self._commit_frame
                if e - s <= 0:
                    continue
            out.append((s / FRAME_RATE, e / FRAME_RATE) if in_second else (int(s), int(e)))
            self._commit_frame = e
        # drop audio that no later window reaches
        keep_from = max(0, self._total - self.window - self.hop)
        drop = keep_from - (self._total - len(self._buf))
        if drop > 0:
            self._buf = self._buf[drop:]
        return out
