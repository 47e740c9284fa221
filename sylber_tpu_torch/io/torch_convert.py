"""HF ``HubertModel`` / ``sylber.ckpt`` state dict -> the port's state dict.

Mirrors ``sylber_tpu/io/torch_convert.py::hubert_params_from_torch``: the
weight norm of the positional conv is folded into a plain kernel
(w = g * v / ||v||, norm over every dim but 2; old ``weight_g``/``weight_v``
and new ``parametrizations.weight.original{0,1}`` names), names are mapped
onto :class:`sylber_tpu_torch.models.hubert.HubertModel`, and keys the
encoder does not use are dropped (the reference loads with strict=False).
Layouts need no change: both sides are torch.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch


def torch_load(path: str):
    """``torch.load`` restricted to tensors and containers (no pickled code)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _fold_weight_norm(sd: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """The effective (out, in/groups, k) weight of a weight-normed conv."""
    for g_key, v_key in ((f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1"),
                         (f"{prefix}.weight_g", f"{prefix}.weight_v")):
        if g_key in sd:
            g, v = sd[g_key], sd[v_key]
            norm = v.double().pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
            return (g * v / norm).to(v.dtype)
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    raise KeyError(f"positional conv weight not found under {prefix}")


def state_dict_from_hf(sd: Mapping[str, torch.Tensor],
                       num_hidden_layers: int = 9) -> Dict[str, torch.Tensor]:
    """Map an HF ``HubertModel`` state dict onto the port's module names."""
    out: Dict[str, torch.Tensor] = {}

    def take(src: str, dst: str) -> None:
        out[dst] = sd[src]

    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        take(f"feature_extractor.conv_layers.{i}.conv.weight",
             f"feature_extractor.convs.{i}.weight")
        i += 1
    if i == 0:
        raise KeyError("no conv frontend weights found")
    for p in ("weight", "bias"):
        take(f"feature_extractor.conv_layers.0.layer_norm.{p}",
             f"feature_extractor.group_norm.{p}")
        take(f"feature_projection.layer_norm.{p}", f"feature_projection.layer_norm.{p}")
        take(f"feature_projection.projection.{p}", f"feature_projection.projection.{p}")
        take(f"encoder.layer_norm.{p}", f"encoder_layer_norm.{p}")
    take("masked_spec_embed", "masked_spec_embed")
    out["pos_conv_embed.conv.weight"] = _fold_weight_norm(sd, "encoder.pos_conv_embed.conv")
    take("encoder.pos_conv_embed.conv.bias", "pos_conv_embed.conv.bias")

    for li in range(num_hidden_layers):
        src, dst = f"encoder.layers.{li}", f"layers.{li}"
        for p in ("weight", "bias"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                take(f"{src}.attention.{proj}.{p}", f"{dst}.attention.{proj}.{p}")
            for name in ("layer_norm", "final_layer_norm"):
                take(f"{src}.{name}.{p}", f"{dst}.{name}.{p}")
            for name in ("intermediate_dense", "output_dense"):
                take(f"{src}.feed_forward.{name}.{p}", f"{dst}.{name}.{p}")
    return {k: v.float() for k, v in out.items()}


def load_torch_checkpoint(path: str, num_hidden_layers: int = 9) -> Dict[str, torch.Tensor]:
    """Load a bare HF state dict or a Lightning checkpoint whose keys carry a
    ``net.speech_model.`` (or ``speech_model.``, ``model.``) prefix."""
    obj = torch_load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    for prefix in ("net.speech_model.", "speech_model.", "model."):
        if any(k.startswith(prefix) for k in obj):
            obj = {k[len(prefix):]: v for k, v in obj.items() if k.startswith(prefix)}
            break
    return state_dict_from_hf(obj, num_hidden_layers=num_hidden_layers)
