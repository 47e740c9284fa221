"""HuBERT frontend layer 0: Conv1d(k, s) + GroupNorm + erf GELU.

Port of ``sylber_tpu/ops/pallas/frontend.py::fused_conv0_gn_gelu``, for
any taps ``k`` and stride ``s`` with ``k <= 2 s`` (the Pallas kernel's
condition) and ``k <= KMAX``; HuBERT's is (10, 5). On a CUDA tensor
:func:`conv0_gn_gelu` launches the kernels of ``csrc/frontend.cu`` (its
header says what bounds them and how the design answers that; (10, 5) has
kernels of its own, any other shape runtime-shaped ones): the GroupNorm
moments come from the waveform alone, as ``k + k (k + 1) / 2`` sums per
batch item in fp64 (:func:`analytic_moments_plain` is the formula, the JAX
package's ``_analytic_l0_stats``), then one pass recomputes the conv,
normalises, applies the GELU (erf to 1.5e-7, the TPU kernel's polynomial)
and writes the output once. On a CPU tensor it runs
:func:`conv0_gn_gelu_plain`.

GroupNorm has one group per channel, so its moments are per (batch item,
channel) over every frame of the input as given, zero padding included: the
HF behaviour the model keeps, which is why the Segmenter pads to the same
buckets as the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import check, device_of, lib, require_cuda, stream_of

KERNEL_SIZE, STRIDE = 10, 5   # HuBERT's layer 0
KMAX = 32                     # csrc/frontend.cu: the most taps its kernels take


def fits_kernel(k: int, s: int) -> bool:
    """Whether the kernels take taps ``k`` at stride ``s``."""
    return 1 <= k <= KMAX and k <= 2 * s


def conv0_gn_gelu_plain(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, stride: int = STRIDE, eps: float = 1e-5,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference: ``F.conv1d`` -> ``F.group_norm(groups=D)`` -> erf GELU, fp32."""
    y = F.conv1d(x.float()[:, None, :], w.float(), stride=stride)
    y = F.group_norm(y, y.shape[1], gamma.float(), beta.float(), eps)
    return F.gelu(y).to(out_dtype)


def analytic_moments_plain(x: torch.Tensor, w: torch.Tensor, stride: int = STRIDE):
    """Mean and biased variance over time of ``conv1d(x, w, stride=s)`` per
    (batch item, channel), from the waveform without the conv, in fp64.

    For ``y[t, c] = sum_j w[c, j] x[s t + j]``: ``sum_t y = w_c . u`` with
    ``u_j = sum_t x[s t + j]``, and ``sum_t y^2 = w_c' G w_c`` with
    ``G[j, l] = sum_t x[s t + j] x[s t + l]``. Returns two (B, D) float64."""
    k = w.shape[-1]
    T0 = (x.shape[1] - k) // stride + 1
    taps = x.double().unfold(1, k, stride)                     # (B, T0, k)
    u = taps.sum(1)                                            # (B, k)
    G = torch.einsum("btj,btl->bjl", taps, taps)               # (B, k, k)
    wd = w.double().reshape(w.shape[0], k)                     # (D, k)
    mean = u @ wd.T / T0
    var = torch.einsum("bjl,dj,dl->bd", G, wd, wd) / T0 - mean * mean
    return mean, var.clamp_min(0.0)


def conv0_gn_gelu(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, *, stride: int = STRIDE, eps: float = 1e-5,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``gelu(group_norm(conv1d(x, w, stride)))``.

    Args:
      x: (B, L) float32 waveform.
      w: (D, 1, k) conv weight, torch layout, no bias; ``k <= 2 stride``,
        ``k <= KMAX``.
      gamma, beta: (D,) GroupNorm affine.
      out_dtype: float32 or bfloat16; the arithmetic is fp32 either way.

    Returns (B, D, T0) with T0 = (L - k) // stride + 1, the layout the next
    ``Conv1d`` reads (the JAX function returns its transpose).
    """
    if x.device.type == "cpu":
        return conv0_gn_gelu_plain(x, w, gamma, beta, stride=stride, eps=eps,
                                   out_dtype=out_dtype)
    B, L = x.shape
    D, k = w.shape[0], w.shape[-1]
    if tuple(w.shape) != (D, 1, k) or not fits_kernel(k, stride):
        raise ValueError(f"conv0_gn_gelu: weight must be (D, 1, k) with k <= 2 x stride "
                         f"and k <= {KMAX}, got {tuple(w.shape)} at stride {stride}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv0_gn_gelu: out_dtype {out_dtype} not supported")
    for name, t in (("x", x), ("w", w), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise ValueError(f"conv0_gn_gelu: {name} must be float32, got {t.dtype}")
    T0 = (L - k) // stride + 1
    if T0 < 1:
        raise ValueError(f"conv0_gn_gelu: input of {L} samples is shorter "
                         f"than the {k}-tap kernel")
    require_cuda("conv0_gn_gelu", x, w, gamma, beta)
    return _launch(x, w, gamma, beta, T0, eps, out_dtype, stride)


def _launch(x, w, gamma, beta, T0, eps, out_dtype, stride=STRIDE) -> torch.Tensor:
    (B, L), D, k = x.shape, w.shape[0], w.shape[-1]
    kl = lib()
    part = torch.empty(kl.sylber_conv0_partials_size(B, T0, k, stride),
                       dtype=torch.float64, device=x.device)
    fold = torch.empty(B, D, 2, dtype=torch.float32, device=x.device)
    out = torch.empty(B, D, T0, dtype=out_dtype, device=x.device)
    with device_of(x):
        check(kl.sylber_conv0_gn_gelu(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            part.data_ptr(), fold.data_ptr(), out.data_ptr(), B, L, T0, D, k, stride,
            float(eps), int(out_dtype == torch.bfloat16), stream_of(x)), "conv0_gn_gelu")
    conv0_gn_gelu.launches += 1
    return out


conv0_gn_gelu.launches = 0
