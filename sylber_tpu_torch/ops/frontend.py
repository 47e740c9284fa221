"""HuBERT frontend layer 0: Conv1d(k=10, s=5) + GroupNorm + exact GELU.

Port of ``sylber_tpu/ops/pallas/frontend.py::fused_conv0_gn_gelu``. On a
CUDA tensor :func:`conv0_gn_gelu` launches the two-phase kernel of
``csrc/frontend.cu`` (its header says what bounds it and how the design
answers that); on a CPU tensor it runs :func:`conv0_gn_gelu_plain`.

GroupNorm has one group per channel, so its moments are per (batch item,
channel) over every frame of the input as given, zero padding included: the
HF behaviour the model keeps, which is why the Segmenter pads to the same
buckets as the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import check, lib, require_cuda, stream_of

KERNEL_SIZE, STRIDE = 10, 5


def conv0_gn_gelu_plain(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, eps: float = 1e-5,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference: ``F.conv1d`` -> ``F.group_norm(groups=D)`` -> erf GELU, fp32."""
    y = F.conv1d(x.float()[:, None, :], w.float(), stride=STRIDE)
    y = F.group_norm(y, y.shape[1], gamma.float(), beta.float(), eps)
    return F.gelu(y).to(out_dtype)


def conv0_gn_gelu(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, *, eps: float = 1e-5,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``gelu(group_norm(conv1d(x, w)))``.

    Args:
      x: (B, L) float32 waveform.
      w: (D, 1, 10) conv weight, torch layout, no bias.
      gamma, beta: (D,) GroupNorm affine.
      out_dtype: float32 or bfloat16; the arithmetic is fp32 either way.

    Returns (B, D, T0) with T0 = (L - 10) // 5 + 1, the layout the next
    ``Conv1d`` reads (the JAX function returns its transpose).
    """
    if x.device.type == "cpu":
        return conv0_gn_gelu_plain(x, w, gamma, beta, eps=eps,
                                   out_dtype=out_dtype)
    B, L = x.shape
    D = w.shape[0]
    if tuple(w.shape) != (D, 1, KERNEL_SIZE):
        raise ValueError(f"conv0_gn_gelu: weight must be (D, 1, {KERNEL_SIZE}), "
                         f"got {tuple(w.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv0_gn_gelu: out_dtype {out_dtype} not supported")
    for name, t in (("x", x), ("w", w), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise ValueError(f"conv0_gn_gelu: {name} must be float32, got {t.dtype}")
    T0 = (L - KERNEL_SIZE) // STRIDE + 1
    if T0 < 1:
        raise ValueError(f"conv0_gn_gelu: input of {L} samples is shorter "
                         f"than the {KERNEL_SIZE}-tap kernel")
    require_cuda("conv0_gn_gelu", x, w, gamma, beta)
    kl = lib()
    part = torch.empty(kl.sylber_conv0_partials_size(B, T0, D),
                       dtype=torch.float32, device=x.device)
    out = torch.empty(B, D, T0, dtype=out_dtype, device=x.device)
    check(kl.sylber_conv0_gn_gelu(
        x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, L, T0, D, float(eps),
        int(out_dtype == torch.bfloat16), stream_of(x)), "conv0_gn_gelu")
    conv0_gn_gelu.launches += 1
    return out


conv0_gn_gelu.launches = 0
