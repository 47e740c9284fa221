"""Weight bridge from the JAX package's parameter trees.

``load_params_npz`` reads the single-file ``.npz`` format of
``sylber_tpu.io.checkpoint.save_params_npz`` (keys are '/'-joined tree
paths); ``state_dict_from_jax_params`` turns such a tree into the state dict
of :class:`sylber_tpu_torch.models.hubert.HubertModel`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_params_npz(path: str, dtype=np.float32) -> Dict[str, Any]:
    """Nested dict of numpy arrays; floating leaves cast to ``dtype``
    (checked-in fixtures store float16)."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            a = z[key]
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(dtype)
            node[parts[-1]] = a
    return out


# JAX tree node name -> port module path
_RENAMES = ((re.compile(r"^feature_extractor\.conv_(\d+)\."), r"feature_extractor.convs.\1."),
            (re.compile(r"^layer_(\d+)\."), r"layers.\1."))


def _leaf(name: str, a: np.ndarray):
    """flax leaf -> (torch leaf name, tensor in torch layout)."""
    if name == "kernel":
        if a.ndim == 2:    # Dense (in, out) -> Linear (out, in)
            a = a.T
        elif a.ndim == 3:  # Conv (k, in/groups, out) -> (out, in/groups, k)
            a = np.transpose(a, (2, 1, 0))
        return "weight", a
    if name == "scale":    # LayerNorm / GroupNorm
        return "weight", a
    return name, a


def state_dict_from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's HubertModel state dict from the JAX ``HubertModel`` tree."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            leaf, a = _leaf(name, np.asarray(value))
            key = f"{prefix}{leaf}"
            for pattern, repl in _RENAMES:
                key = pattern.sub(repl, key)
            sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))

    walk(tree, "")
    return sd
