"""HuBERT frontend layer 0: Conv1d(k=10, s=5) + GroupNorm + erf GELU.

Port of ``sylber_tpu/ops/pallas/frontend.py::fused_conv0_gn_gelu``. On a
CUDA tensor :func:`conv0_gn_gelu` launches the kernels of
``csrc/frontend.cu`` (its header says what bounds them and how the design
answers that): the GroupNorm moments come from the waveform alone, as 10 + 55
sums per batch item in fp64 (:func:`analytic_moments_plain` is the formula,
the JAX package's ``_analytic_l0_stats``), then one pass recomputes the conv,
normalises, applies the GELU (erf to 1.5e-7, the TPU kernel's polynomial) and
writes the output once. On a CPU tensor it runs :func:`conv0_gn_gelu_plain`.

GroupNorm has one group per channel, so its moments are per (batch item,
channel) over every frame of the input as given, zero padding included: the
HF behaviour the model keeps, which is why the Segmenter pads to the same
buckets as the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import check, device_of, lib, require_cuda, stream_of

KERNEL_SIZE, STRIDE = 10, 5


def conv0_gn_gelu_plain(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, eps: float = 1e-5,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference: ``F.conv1d`` -> ``F.group_norm(groups=D)`` -> erf GELU, fp32."""
    y = F.conv1d(x.float()[:, None, :], w.float(), stride=STRIDE)
    y = F.group_norm(y, y.shape[1], gamma.float(), beta.float(), eps)
    return F.gelu(y).to(out_dtype)


def analytic_moments_plain(x: torch.Tensor, w: torch.Tensor):
    """Mean and biased variance over time of ``conv1d(x, w, stride=5)`` per
    (batch item, channel), from the waveform without the conv, in fp64.

    For ``y[t, c] = sum_j w[c, j] x[5t + j]``: ``sum_t y = w_c . u`` with
    ``u_j = sum_t x[5t + j]``, and ``sum_t y^2 = w_c' G w_c`` with
    ``G[j, l] = sum_t x[5t + j] x[5t + l]``. Returns two (B, D) float64."""
    T0 = (x.shape[1] - KERNEL_SIZE) // STRIDE + 1
    taps = x.double().unfold(1, KERNEL_SIZE, STRIDE)           # (B, T0, 10)
    u = taps.sum(1)                                            # (B, 10)
    G = torch.einsum("btj,btl->bjl", taps, taps)               # (B, 10, 10)
    wd = w.double().reshape(w.shape[0], KERNEL_SIZE)           # (D, 10)
    mean = u @ wd.T / T0
    var = torch.einsum("bjl,dj,dl->bd", G, wd, wd) / T0 - mean * mean
    return mean, var.clamp_min(0.0)


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
    return _launch(x, w, gamma, beta, T0, eps, out_dtype)


def _launch(x, w, gamma, beta, T0, eps, out_dtype) -> torch.Tensor:
    (B, L), D = x.shape, w.shape[0]
    kl = lib()
    part = torch.empty(kl.sylber_conv0_partials_size(B, T0),
                       dtype=torch.float64, device=x.device)
    fold = torch.empty(B, D, 2, dtype=torch.float32, device=x.device)
    out = torch.empty(B, D, T0, dtype=out_dtype, device=x.device)
    with device_of(x):
        check(kl.sylber_conv0_gn_gelu(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            part.data_ptr(), fold.data_ptr(), out.data_ptr(), B, L, T0, D, float(eps),
            int(out_dtype == torch.bfloat16), stream_of(x)), "conv0_gn_gelu")
    conv0_gn_gelu.launches += 1
    return out


conv0_gn_gelu.launches = 0
