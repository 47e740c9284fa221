"""Seeded random weights of a HuBERT encoder, drawn on the device.

The benchmark makes the weights and hands the same tensors to the program
(through its state-dict interface) and to the reference. The distributions
are those of the port's seeded initialisation: normal(0, fan_in^-1/2) for
conv weights, normal(0, 0.02) for linear weights, ones and zeros for the
norms, zero biases, uniform(0, 1) for the mask embedding. All normal draws
come from one call on the device and are cut into the leaves.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    if name == "masked_spec_embed":
        return "uniform"
    if name.endswith("bias"):
        return "zeros"
    if len(shape) == 1:
        return "ones"       # LayerNorm and GroupNorm weights
    return "normal"


def seeded_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """float32 leaves for each name of ``shapes`` (a state dict's layout)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = [(n, s) for n, s in shapes.items() if _kind(n, s) == "normal"]
    total = sum(int(torch.Size(s).numel()) for _, s in normal)
    draws = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in normal:
        n = int(torch.Size(shape).numel())
        std = (shape[1] * shape[2]) ** -0.5 if len(shape) == 3 else 0.02
        out[name] = draws[at: at + n].view(shape).mul_(std)
        at += n
    for name, shape in shapes.items():
        kind = _kind(name, shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "uniform":
            out[name] = torch.rand(shape, generator=gen, device=device)
    return {n: out[n] for n in shapes}
