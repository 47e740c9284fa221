"""Frozen k-means quantizers for syllable tokens (5K/10K/20K units).

Port of the k-means part of ``sylber_tpu/flow/quantizer.py``:

- :class:`KMQuantizer`: frozen centroids; encode is the nearest centroid
  (one argmin over a distance matmul), decode a table lookup, a call both
  with the commitment loss; optionally the inputs are first scaled to norm 6;
- :class:`ResidualKMQuantizer`: two stages, the second quantizing the
  residual of the first.

The centroids live on one device, ``cuda`` unless ``device="cpu"`` is
passed. Indices are int32, as in the JAX package. The trainable grouped residual VQ
is in ``flow/quantizer.py``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .api import resolve_device
from .models.hubert import matmul_precision


def _nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 through the expanded form |c_k|^2 - 2 x.c_k.

    The matmul runs at full fp32 precision: TF32 flips near-ties."""
    K, d = centroids.shape
    with matmul_precision("highest"):
        dots = x.reshape(-1, d).float() @ centroids.T
    c2 = (centroids.float() ** 2).sum(-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1).reshape(x.shape[:-1]).to(torch.int32)


class KMQuantizer:
    """Frozen k-means codebook. ``centroids``: (K, d) array or .npy path."""

    def __init__(self, centroids, normalize: bool = False,
                 device: Union[None, str, torch.device] = None):
        if isinstance(centroids, str):
            centroids = np.load(centroids)
        centroids = np.asarray(centroids, np.float32)
        if centroids.ndim != 2:
            raise ValueError(f"centroids must be (K, d), got shape {centroids.shape}")
        self.centroids = torch.from_numpy(centroids).to(resolve_device(device))
        self.normalize = normalize

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def get_indices(self, token) -> torch.Tensor:
        token = torch.as_tensor(token, device=self.device)
        if self.normalize:
            token = token / torch.sqrt((token ** 2).sum(-1, keepdim=True) + 1e-8) * 6.0
        return _nearest(token, self.centroids)

    def decode(self, indices) -> torch.Tensor:
        indices = torch.as_tensor(indices, device=self.device).clamp(0, len(self.centroids) - 1)
        if indices.ndim and indices.shape[-1] == 1:
            indices = indices[..., 0]
        return self.centroids[indices.long()]

    def __call__(self, token):
        token = torch.as_tensor(token, device=self.device)
        idx = self.get_indices(token)
        q = self.decode(idx)
        return {"indices": idx, "quantize": q, "non_quantized": token,
                "commitment_loss": ((token - q) ** 2).mean()}


class ResidualKMQuantizer:
    """Two-stage residual k-means; only the first stage normalises."""

    def __init__(self, centroids, centroids2, normalize: bool = False,
                 device: Union[None, str, torch.device] = None):
        self.km = KMQuantizer(centroids, normalize=normalize, device=device)
        self.km2 = KMQuantizer(centroids2, device=self.km.device)

    @property
    def device(self) -> torch.device:
        return self.km.device

    def get_indices(self, token) -> torch.Tensor:
        token = torch.as_tensor(token, device=self.device)
        i1 = self.km.get_indices(token)
        i2 = self.km2.get_indices(token - self.km.decode(i1))
        return torch.stack([i1, i2], dim=-1)

    def decode(self, indices) -> torch.Tensor:
        indices = torch.as_tensor(indices, device=self.device)
        return self.km.decode(indices[..., 0]) + self.km2.decode(indices[..., 1])


def load_km_quantizer(centroids, residual_centroids=None, normalize: bool = False,
                      device: Union[None, str, torch.device] = None):
    """The reference's loader surface."""
    if residual_centroids is not None:
        return ResidualKMQuantizer(centroids, residual_centroids, normalize=normalize,
                                   device=device)
    return KMQuantizer(centroids, normalize=normalize, device=device)
