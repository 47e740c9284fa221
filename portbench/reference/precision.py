"""Lower precisions emulated in float32, for the controls of the check.

``fp8``: each operand rounded to float8 e4m3 under a per-tensor scale that
maps its largest magnitude to 448, as fp8 training scales its GEMM inputs;
the rounding passes the gradient through unchanged.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    d = t.detach()
    scale = d.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (d / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - d) if t.requires_grad else q
