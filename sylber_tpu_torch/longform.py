"""Long-form segmentation: chunked inference with overlap stitching.

Port of ``sylber_tpu/longform.py``. The recording is cut into windows of
``chunk_seconds`` (default 30 s) that overlap by ``overlap_seconds``
(default 2 s), each aligned to the 320-sample frame grid, so window frames
map exactly onto global frames. The windows run through the ``Segmenter``
``batch_windows`` at a time; each pair of neighbours is cut at the frame of
the overlap whose summed frame norms are lowest; segments are kept or
truncated at the cuts. Untruncated segments keep the features pooled in
their window; truncated ones are pooled again from the window's hidden
states, all of them in one batched masked mean.

``return_hidden=True`` also returns the stitched hidden-state track and
always runs float32 windows. ``return_hidden=False`` takes the resident
path by default (``transfer="int16"``): the recording is uploaded once as
int16 PCM scaled to its peak, the windows are gathered from it on the
device, and every window batch is enqueued before any result is fetched.
Its windows are padded to the same bucketed length as the float path's (the
GroupNorm of frontend layer 0 takes its moments over the padded length), so
the two paths differ only by the int16 quantisation, 1/32767 of the peak;
their boundary agreement is held to F1 >= 0.995 at tolerance 0.
``transfer="float32"`` keeps the float window path for parity work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .api import FRAME_RATE, Segmenter, _round_up
from .models.hubert import matmul_precision

FRAME = 320


def masked_mean_pool(h: torch.Tensor, ls: torch.Tensor, le: torch.Tensor) -> torch.Tensor:
    """Mean of ``h[k, ls[k]:le[k]]`` for each k: (K, T, d) -> (K, d).

    A masked einsum at full fp32 precision: with TF32 the pooled features
    would drift about 1e-3 from the window-pooled ones."""
    t = torch.arange(h.shape[1], device=h.device)[None, :]
    m = ((t >= ls[:, None]) & (t < le[:, None])).to(h.dtype)
    with matmul_precision("highest"):
        pooled = torch.einsum("kt,ktd->kd", m, h)
    return pooled / (le - ls).clamp_min(1)[:, None].to(h.dtype)


class LongFormSegmenter:
    """Chunked segmentation for arbitrarily long audio.

    ``LongFormSegmenter(segmenter)(wav or wav_file, in_second=True)`` returns
    the ``Segmenter`` dict contract. It runs on the segmenter's device.
    """

    def __init__(self, segmenter: Segmenter, chunk_seconds: float = 30.0,
                 overlap_seconds: float = 2.0, batch_windows: int = 8,
                 transfer: str = "int16") -> None:
        if not overlap_seconds * 2 < chunk_seconds:
            raise ValueError("overlap_seconds must be under half of chunk_seconds")
        if transfer not in ("int16", "float32"):
            raise ValueError(f"transfer must be 'int16' or 'float32', got {transfer!r}")
        self.segmenter = segmenter
        self.chunk_frames = int(chunk_seconds * FRAME_RATE)
        self.overlap_frames = int(overlap_seconds * FRAME_RATE)
        self.batch_windows = batch_windows
        self.transfer = transfer

    def __call__(self, wav=None, wav_file=None, in_second: bool = True,
                 norm_threshold: Optional[float] = None,
                 merge_threshold: Optional[float] = None,
                 return_hidden: bool = True) -> Dict:
        if wav_file is not None:
            from .utils.audio import load_for_inference

            wav = load_for_inference(wav_file)
        wav = np.asarray(wav, np.float32).reshape(-1)
        starts = self._starts(len(wav))

        if len(starts) == 1:
            return self.segmenter(wav=wav, in_second=in_second,
                                  norm_threshold=norm_threshold,
                                  merge_threshold=merge_threshold)

        if (self.transfer == "int16" and not return_hidden
                and self.segmenter.mesh is None):
            results = self._collect_resident(self._dispatch_resident(
                wav, starts, norm_threshold, merge_threshold))
        else:
            windows = []
            for s in starts:
                lo = s * FRAME
                hi = min((s + self.chunk_frames) * FRAME + FRAME, len(wav))
                windows.append(wav[lo:hi])
            results = []
            for i in range(0, len(windows), self.batch_windows):
                results.extend(self.segmenter.process(
                    windows[i: i + self.batch_windows], in_second=False,
                    norm_threshold=norm_threshold, merge_threshold=merge_threshold,
                    return_hidden=True if return_hidden else "device"))

        cuts = self._cuts(starts, results)
        stitched = self._stitch_segments(starts, results, cuts)

        if return_hidden:
            hidden = self._stitch_hidden(starts, results, cuts)
            feats = (np.stack([hidden[s:e].mean(0) for _, s, e, _ in stitched])
                     if stitched else np.array([]))
        else:
            hidden = None
            feats = self._features_fast(starts, results, stitched)

        segments = np.asarray([[s, e] for _, s, e, _ in stitched], np.int64).reshape(-1, 2)
        out = {
            "segments": segments / FRAME_RATE if in_second else segments,
            "segment_features": feats,
        }
        if return_hidden:
            out["hidden_states"] = hidden
        return out

    def _starts(self, n_samples: int) -> List[int]:
        """First frame of each window of a recording of ``n_samples``."""
        total_frames = max(n_samples // FRAME - 1, 1)
        step = self.chunk_frames - self.overlap_frames
        return list(range(0, max(total_frames - self.overlap_frames, 1), step))

    # ------------------------------------------------------------------
    # resident path

    def _dispatch_resident(self, wav: np.ndarray, starts: List[int],
                           norm_threshold: Optional[float],
                           merge_threshold: Optional[float]) -> List[tuple]:
        """Upload the recording once as peak-scaled int16 PCM, gather the
        windows on the device and enqueue every window batch. Reads nothing
        back: returns (hidden, result, nvalid) a batch, for
        ``Segmenter._collect``.

        Windows are ``Wp = round_up(max(W, 400), length_bucket)`` samples, the
        float path's padded length, with the samples past each window's
        ``nvalid`` zeroed and masked. Padded rows of the last batch repeat
        its last start with ``nvalid = 0``; their results are dropped."""
        seg = self.segmenter
        nt = seg.norm_threshold if norm_threshold is None else float(norm_threshold)
        mt = seg.merge_threshold if merge_threshold is None else float(merge_threshold)
        W = self.chunk_frames * FRAME + FRAME
        Wp = _round_up(max(W, 400), max(seg.length_bucket, 1))
        scale = 32767.0 / max(float(np.abs(wav).max()), 1e-6)
        inv_scale = float(np.float32(1.0 / scale))
        pcm = np.zeros(max(starts[-1] * FRAME + Wp, len(wav)), np.int16)
        pcm[: len(wav)] = np.round(wav * scale)

        B = self.batch_windows
        nbatch = -(-len(starts) // B)
        st = np.empty((nbatch, B), np.int64)
        nv = np.zeros((nbatch, B), np.int64)
        n_real = []
        for i in range(nbatch):
            chunk = starts[i * B: (i + 1) * B]
            n_real.append(len(chunk))
            st[i] = chunk + [chunk[-1]] * (B - len(chunk))
            nv[i, : len(chunk)] = np.minimum(np.maximum(len(wav) - st[i, : len(chunk)] * FRAME, 0),
                                             W)
        # every upload happens before the first forward is enqueued
        dev = seg.device
        pcm_dev = torch.from_numpy(pcm).to(dev)
        st_dev, nv_dev = torch.from_numpy(st).to(dev), torch.from_numpy(nv).to(dev)
        return [(hidden, res, nv[i, : n_real[i]]) for i, (hidden, res) in enumerate(
            self._enqueue_windows(pcm_dev, st_dev, nv_dev, Wp, inv_scale, nt, mt))]

    def _collect_resident(self, raw: List[tuple]) -> List[Dict]:
        """Fetch what ``_dispatch_resident`` enqueued: one result a window,
        its hidden states left on the device. The first host wait."""
        return [out for hidden, res, nvalid in raw for out in self.segmenter._collect(
            hidden, res, nvalid, in_second=False, return_hidden="device")]

    def _enqueue_windows(self, pcm, starts, nvalid, Wp, inv_scale, nt, mt):
        """Gather each batch's windows from the resident PCM and enqueue its
        forward and segmentation; ``starts`` and ``nvalid`` are (batches, B)
        device tensors. Nothing here waits for the device."""
        windows = pcm.unfold(0, Wp, FRAME)  # row s: the Wp samples from s * FRAME
        t = torch.arange(Wp, device=pcm.device)[None, :]
        out = []
        for st, nv in zip(starts, nvalid):
            mask = (t < nv[:, None]).to(torch.int32)
            x = windows[st].float() * inv_scale * mask
            out.append(self.segmenter._forward_segment(x, mask, nt, mt))
        return out

    # ------------------------------------------------------------------
    # stitching

    def _cuts(self, starts: List[int], results: List[Dict]) -> List[int]:
        """Cut frame per overlap: lowest combined frame norm."""
        cuts = []
        for i in range(len(results) - 1):
            ov_lo = starts[i + 1]
            ov_hi = min(starts[i] + len(results[i]["frame_norms"]),
                        starts[i + 1] + len(results[i + 1]["frame_norms"]))
            if ov_hi <= ov_lo:
                cuts.append(ov_lo)
                continue
            a = results[i]["frame_norms"][ov_lo - starts[i]: ov_hi - starts[i]]
            b = results[i + 1]["frame_norms"][: ov_hi - ov_lo]
            m = min(len(a), len(b))
            cuts.append(ov_lo + int(np.argmin(a[:m] + b[:m])) if m else ov_lo)
        return cuts

    def _stitch_segments(self, starts, results, cuts) -> List[Tuple[int, int, int, bool]]:
        """-> [(window_idx, start, end, truncated)], global frames."""
        n = len(results)
        out: List[Tuple[int, int, int, bool]] = []
        for i in range(n):
            lo = -1 if i == 0 else cuts[i - 1]
            hi = np.inf if i == n - 1 else cuts[i]
            segs = np.asarray(results[i]["segments"], np.int64).reshape(-1, 2) + starts[i]
            for s, e in segs:
                s2, e2 = max(s, lo if lo >= 0 else s), min(e, hi)
                if e2 - s2 <= 0:
                    continue
                if out and out[-1][2] > s2:
                    s2 = out[-1][2]
                    if e2 - s2 <= 0:
                        continue
                out.append((i, int(s2), int(e2), (s2 != s or e2 != e)))
        return out

    def _stitch_hidden(self, starts, results, cuts) -> np.ndarray:
        n = len(results)
        pieces = []
        for i in range(n):
            h = results[i]["hidden_states"]
            lo = starts[i] if i == 0 else cuts[i - 1]
            hi = starts[i] + len(h) if i == n - 1 else cuts[i]
            pieces.append(h[lo - starts[i]: hi - starts[i]])
        return np.concatenate(pieces, axis=0)

    def _features_fast(self, starts, results, stitched) -> np.ndarray:
        """Window-pooled features for untruncated segments; the segments cut
        at a cut frame are pooled again from the windows' hidden states, all
        in one masked mean and one fetch when those are tensors."""
        if not stitched:
            return np.array([])
        feats: List[Optional[np.ndarray]] = [None] * len(stitched)
        repool = []  # (slot, window, local_start, local_end)
        first = {}   # window -> {(start, end): index of its first segment so}
        for slot, (w, s, e, truncated) in enumerate(stitched):
            if not truncated:
                if w not in first:
                    segs_w = np.asarray(results[w]["segments"], np.int64).reshape(-1, 2)
                    first[w] = {}
                    for j, (a, b) in enumerate((segs_w + starts[w]).tolist()):
                        first[w].setdefault((a, b), j)
                j = first[w].get((s, e))
                if j is not None:
                    feats[slot] = np.asarray(results[w]["segment_features"][j])
                    continue
            repool.append((slot, w, s - starts[w], e - starts[w]))

        if repool:
            hs = [results[w]["hidden_states_device"] for _, w, _, _ in repool]
            if isinstance(hs[0], torch.Tensor):
                for slot, f in zip((r[0] for r in repool), self._batched_repool(hs, repool)):
                    feats[slot] = f
            else:  # host arrays
                for (slot, _, ls, le), h in zip(repool, hs):
                    feats[slot] = np.asarray(h[ls:le]).mean(0)
        return np.stack(feats)

    @staticmethod
    def _batched_repool(hs: List[torch.Tensor], repool) -> np.ndarray:
        """Masked mean of K (window, start, end) spans in one batched call.
        Windows of different padded lengths (the last batch of the float
        path) are zero-padded to the longest; the mask ends inside each."""
        T = max(h.shape[0] for h in hs)
        h = torch.stack([F.pad(x, (0, 0, 0, T - x.shape[0])) for x in hs])
        span = torch.tensor([(r[2], r[3]) for r in repool], device=h.device)
        return masked_mean_pool(h, span[:, 0], span[:, 1]).cpu().numpy()
