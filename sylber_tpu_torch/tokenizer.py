"""SylberTokenizer: speech -> discrete syllable tokens -> features.

Port of ``sylber_tpu/tokenizer.py``: the ``Segmenter`` and a k-means
quantizer as one tokenization surface (the 5K/10K/20K-unit variants)::

    tok = SylberTokenizer(segmenter, centroids="centroids_5k.npy")
    out = tok(wav_file="utt.wav")
    # out["tokens"]: (n,) int32 ids, out["segments"]: (n, 2) seconds,
    # out["durations"]: (n,) frames
    feats = tok.decode(out["tokens"])       # (n, d) centroid features

The centroids live on the segmenter's device; tokens are computed there and
returned as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from .api import FRAME_RATE, Segmenter
from .quantizer import KMQuantizer, ResidualKMQuantizer


class SylberTokenizer:
    def __init__(self, segmenter: Segmenter, centroids=None, residual_centroids=None,
                 normalize: bool = False, quantizer=None) -> None:
        self.segmenter = segmenter
        if quantizer is not None:
            self.quantizer = quantizer
        elif residual_centroids is not None:
            self.quantizer = ResidualKMQuantizer(centroids, residual_centroids,
                                                 normalize=normalize, device=segmenter.device)
        elif centroids is not None:
            self.quantizer = KMQuantizer(centroids, normalize=normalize,
                                         device=segmenter.device)
        else:
            raise ValueError("pass centroids or a quantizer")

    def __call__(self, wav_file=None, wav=None, in_second: bool = True
                 ) -> Union[Dict, List[Dict]]:
        outs = self.segmenter(wav_file=wav_file, wav=wav, in_second=in_second)
        is_batch = isinstance(outs, list)
        results = []
        for o in (outs if is_batch else [outs]):
            feats = o["segment_features"]
            segs = o["segments"]
            results.append({
                "tokens": encode(self.quantizer, feats),
                "segments": segs,
                "durations": durations(segs, in_second),
                "segment_features": feats,
            })
        return results if is_batch else results[0]

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """Token ids -> centroid feature vectors (the resynthesis input)."""
        return self.quantizer.decode(torch.as_tensor(tokens)).cpu().numpy()


def encode(quantizer, feats: np.ndarray) -> np.ndarray:
    """Token ids of segment features (K, d), computed on the quantizer's
    device, as numpy int32."""
    if not len(feats):
        return np.zeros((0,), np.int32)
    x = torch.from_numpy(np.asarray(feats, np.float32)).to(quantizer.device)
    return quantizer.get_indices(x).cpu().numpy()


def durations(segments, in_second: bool) -> np.ndarray:
    """Segment lengths in frames, rounded."""
    if not len(segments):
        return np.zeros((0,), int)
    d = np.asarray(segments) * (FRAME_RATE if in_second else 1.0)
    return (d[:, 1] - d[:, 0]).round().astype(int)
