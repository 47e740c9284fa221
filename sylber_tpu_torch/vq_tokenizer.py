"""The trained grouped-residual-VQ tokenizer at inference.

Port of ``sylber_tpu/train/vq_synthesis.py``'s inference class
``TrainedVQTokenizer`` and its ``quantizer_config_from_dict``. The tokenizer
adapts a trained :class:`~sylber_tpu_torch.flow.quantizer.QuantizerState` to
the ``get_indices`` / ``decode`` protocol, so
``SegmentSynthesis(quantizer=TrainedVQTokenizer(...))`` runs the wav ->
tokens -> CFM chain. A token is the concatenated art + pitch code tuple of a
segment. The joint trainer (``make_vq_synthesis_train_step``, the EMA
codebook update) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .api import resolve_device
from .flow.quantizer import (GroupedResidualVQConfig, QuantizerConfig, QuantizerState,
                             VQState, quantizer_decode, quantizer_forward, quantizer_to)


def quantizer_config_from_dict(d: Dict[str, Any], input_dim: int) -> QuantizerConfig:
    """A yaml ``quantizer_configs:`` block -> QuantizerConfig; the art VQ's
    dim defaults to ``output_dim - pitch_emb_dim`` (the reference's split)."""
    d = dict(d or {})
    out_dim = int(d.get("output_dim", 64))
    pitch_dim = int(d.get("pitch_emb_dim", 8))
    art = dict(d.get("art_vq", {}))
    pitch = dict(d.get("pitch_vq", {}))
    art.setdefault("dim", out_dim - pitch_dim)
    pitch.setdefault("dim", pitch_dim)
    return QuantizerConfig(input_dim=input_dim, output_dim=out_dim,
                           hidden_dims=tuple(d.get("hidden_dims", (256, 256))),
                           pitch_emb_dim=pitch_dim,
                           art_vq=GroupedResidualVQConfig(**art),
                           pitch_vq=GroupedResidualVQConfig(**pitch))


class TrainedVQTokenizer:
    """``get_indices`` / ``decode`` over a trained quantizer state (on one
    device, ``cuda`` unless ``device="cpu"``)."""

    def __init__(self, state: QuantizerState, cfg: QuantizerConfig,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.state = quantizer_to(state, self.device)
        self.cfg = cfg

    def get_indices(self, feats) -> torch.Tensor:
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        return quantizer_forward(self.state, self.cfg, feats)["indices"]

    def decode(self, indices) -> torch.Tensor:
        return quantizer_decode(self.state, self.cfg, torch.as_tensor(indices, device=self.device))

    def save_npz(self, path: str) -> None:
        """The flat ``.npz`` layout of the JAX tokenizer's ``save_npz``."""
        flat = {f"enc_{i}_{k}": v.cpu().numpy() for i, layer in enumerate(self.state.encoder)
                for k, v in layer.items()}
        for name, vq in (("art", self.state.art_vq), ("pitch", self.state.pitch_vq)):
            flat[f"{name}_codebooks"] = vq.codebooks.cpu().numpy()
            flat[f"{name}_sizes"] = vq.cluster_sizes.cpu().numpy()
            flat[f"{name}_avgs"] = vq.embed_avgs.cpu().numpy()
        np.savez(path, **flat)

    @classmethod
    def load_npz(cls, path: str, cfg: QuantizerConfig,
                 device: Union[None, str, torch.device] = None) -> "TrainedVQTokenizer":
        with np.load(path) as z:
            n_layers = 3 * len(cfg.hidden_dims) + 1
            enc = [{"kernel": z[f"enc_{i}_kernel"], "bias": z[f"enc_{i}_bias"]}
                   for i in range(n_layers)]
            vqs = {name: VQState(z[f"{name}_codebooks"], z[f"{name}_sizes"], z[f"{name}_avgs"])
                   for name in ("art", "pitch")}
        return cls(QuantizerState(enc, vqs["art"], vqs["pitch"]), cfg, device=device)
