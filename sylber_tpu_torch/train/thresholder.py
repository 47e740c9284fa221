"""Online norm threshold as 0-d tensors on the device.

Port of ``sylber_tpu/train/thresholder.py``: exponentially decayed
signal/noise Gaussians over frame norms, with the threshold at the root of
the quadratic that equates the two likelihoods. Every value stays a 0-d
tensor on the device of the norms, so the training step reads nothing back.
Under data parallelism the masked means are those of the global batch: each
sum and count is all-reduced over the ``dp`` group (``group=``) before the
division, so every rank holds the same thresholder.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class ThresholderState(NamedTuple):
    signal_mean: torch.Tensor
    signal_var: torch.Tensor
    noise_mean: torch.Tensor
    noise_var: torch.Tensor
    fixed: torch.Tensor  # a fixed threshold, or NaN: estimate from the stats


def thresholder_init(signal_mean: float = 6.10, signal_var: float = 0.87,
                     noise_mean: float = 0.34, noise_var: float = 0.34,
                     threshold: Optional[float] = None,
                     device=None) -> ThresholderState:
    vals = (signal_mean, signal_var, noise_mean, noise_var,
            math.nan if threshold is None else threshold)
    return ThresholderState(*(torch.tensor(v, dtype=torch.float32, device=device)
                              for v in vals))


def get_threshold(state: ThresholderState, eta: float = 1.0) -> torch.Tensor:
    """Gaussian likelihood-ratio threshold, a 0-d tensor."""
    mu_s, mu_n = state.signal_mean, state.noise_mean
    sig_s = torch.sqrt(state.signal_var + 1e-8)
    sig_n = torch.sqrt(state.noise_var + 1e-8)
    a = sig_s ** 2 - sig_n ** 2
    b = -2.0 * sig_s ** 2 * mu_n + 2.0 * sig_n ** 2 * mu_s
    c = (sig_s ** 2 * mu_n ** 2 - sig_n ** 2 * mu_s ** 2
         - 2.0 * sig_n ** 2 * sig_s ** 2 * (math.log(eta) + torch.log(sig_s / sig_n)))
    disc = b ** 2 - 4.0 * a * c
    take_pos = (mu_s > mu_n).float()
    quad = torch.where(disc > 0,
                       (-b + take_pos * torch.sqrt(disc.clamp_min(0.0))) / (2.0 * a),
                       -b / (2.0 * a))
    thr = torch.where(a != 0, quad, -c / b)
    return torch.where(torch.isnan(state.fixed), thr, state.fixed)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None):
    total, cnt = (x * mask).sum(), mask.sum()
    if group is not None:
        both = torch.stack([total, cnt])
        dist.all_reduce(both, group=group)
        total, cnt = both[0], both[1]
    mean = torch.where(cnt > 0, total / cnt.clamp_min(1.0), torch.zeros_like(cnt))
    return mean, cnt


def _update(mean0, var0, x, mask, decay, group=None):
    mask = (torch.ones_like(x) if mask is None else mask).float()
    mean, cnt = _masked_mean(x, mask, group)
    new_mean = decay * mean0 + (1 - decay) * mean
    var, _ = _masked_mean((x - new_mean) ** 2, mask, group)
    new_var = decay * var0 + (1 - decay) * var
    return torch.where(cnt > 0, new_mean, mean0), torch.where(cnt > 0, new_var, var0)


def update_stats(state: ThresholderState, signal: Optional[torch.Tensor] = None,
                 signal_mask: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 noise_mask: Optional[torch.Tensor] = None,
                 decay: float = 0.9999, group=None) -> ThresholderState:
    """Decayed stats update over the masked entries of flat ``signal`` /
    ``noise`` norms; an empty selection leaves its stats as they are, the
    variance uses the updated mean, and a fixed threshold never updates.
    ``group``: the process group whose ranks hold the rest of the batch."""
    sm, sv, nm, nv = state.signal_mean, state.signal_var, state.noise_mean, state.noise_var
    if signal is not None:
        sm, sv = _update(sm, sv, signal, signal_mask, decay, group)
    if noise is not None:
        nm, nv = _update(nm, nv, noise, noise_mask, decay, group)
    est = torch.isnan(state.fixed)
    return ThresholderState(torch.where(est, sm, state.signal_mean),
                            torch.where(est, sv, state.signal_var),
                            torch.where(est, nm, state.noise_mean),
                            torch.where(est, nv, state.noise_var),
                            state.fixed)
