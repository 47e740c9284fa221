"""Conditional flow matching: the ODE samplers, with no host read per step.

Port of the sampling half of ``sylber_tpu/flow/cfm.py`` (``cfm_loss`` and
``mask_from_frac_lengths`` belong to the trainer, not ported yet):

- :func:`sample_midpoint`: y0 = randn * rand_scale, then a fixed grid over
  t = linspace(0, 1, steps) (euler, midpoint or rk4). JAX runs it as a
  ``lax.scan``; here every interval is enqueued from the host without a
  read: the grid is a host-side list of float32 numbers equal to
  ``jnp.linspace``'s, and the step sizes are float32 arithmetic on them, as
  the scan computes them. ``steps=1`` returns y0.
- :func:`odeint_adaptive`: an embedded Runge-Kutta pair (dopri5, tsit5)
  with error-controlled step size. JAX runs a ``lax.while_loop`` whose
  accept/reject, next ``h`` and stop test are device values. Here the
  controller stays on the device too: the host enqueues chunks of
  ``CHUNK_STEPS`` masked steps and reads one 2-number status per chunk (is
  the loop done, and ``t``). A step taken once ``t >= t1`` or the budget is
  spent changes nothing, the accepted and rejected counts included, so the
  trajectory, the counts and ``t_reached`` are those of JAX's loop; what a
  chunk costs beyond the last real step is up to ``CHUNK_STEPS - 1``
  masked steps of vector-field calls. The warning of an exhausted budget
  comes from the read that ends the loop.

Randomness: with ``rand_scale`` 0 (the default) y0 is zero. Otherwise it is
drawn from a ``torch.Generator`` on the device seeded with ``seed``, which
is not JAX's stream; ``y0=`` takes a given start (the tests pass JAX's).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

CHUNK_STEPS = 8  # masked adaptive steps enqueued between two reads of the status


def time_grid(steps: int) -> np.ndarray:
    """float32 ``jnp.linspace(0, 1, steps)``: ``i * float32(1 / (steps - 1))``
    with the last point exactly 1."""
    i = np.arange(steps, dtype=np.float32)
    grid = (i * (np.float32(1.0) / np.float32(steps - 1))).astype(np.float32)
    grid[-1] = 1.0
    return grid


def initial_state(shape, rand_scale: float, seed: int, device) -> torch.Tensor:
    """y0: zeros when ``rand_scale`` is 0, else seeded normal noise times it."""
    if rand_scale == 0.0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device) * rand_scale


def sample_midpoint(apply_fn: Callable, cond_emb: torch.Tensor, dim_out: int,
                    steps: int = 5, rand_scale: float = 0.0, method: str = "midpoint",
                    seed: int = 0, y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate ``apply_fn(x, t) -> dx/dt`` (``t`` a Python float) from 0 to
    1 on a fixed grid of ``steps`` points."""
    if method not in ("euler", "midpoint", "rk4"):
        raise ValueError(f"unknown ODE method {method!r}")
    B, L, _ = cond_emb.shape
    y = initial_state((B, L, dim_out), rand_scale, seed, cond_emb.device) if y0 is None else y0
    if steps <= 1:
        return y
    f32 = np.float32
    ts = time_grid(steps)
    for i in range(steps - 1):
        t0, t1 = ts[i], ts[i + 1]
        h = f32(t1 - t0)
        half = f32(t0 + f32(0.5) * h)
        k1 = apply_fn(y, float(t0))
        if method == "euler":
            y = y + float(h) * k1
        elif method == "midpoint":
            k2 = apply_fn(y + float(f32(0.5) * h) * k1, float(half))
            y = y + float(h) * k2
        else:
            k2 = apply_fn(y + float(f32(0.5) * h) * k1, float(half))
            k3 = apply_fn(y + float(f32(0.5) * h) * k2, float(half))
            k4 = apply_fn(y + float(h) * k3, float(t1))
            y = y + float(h / f32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


# Dormand-Prince 5(4), torchdiffeq's default adaptive solver. FSAL.
_DOPRI5_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI5_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI5_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI5_B_ERR = tuple(
    b - bs for b, bs in zip(
        _DOPRI5_B,
        (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
         187 / 2100, 1 / 40)))

# Tsitouras 5(4) (2011), the torchode method class of the reference. FSAL.
_TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TSIT5_B = _TSIT5_A[6] + (0.0,)
# btilde = b - b* (error-estimate weights), OrdinaryDiffEq.jl convention
_TSIT5_B_ERR = (-0.00178001105222577714, -0.0008164344596567469,
                0.007880878010261995, -0.1447110071732629,
                0.5823571654525552, -0.45808210592918697,
                1 / 66)

_TABLEAUS = {"dopri5": (_DOPRI5_C, _DOPRI5_A, _DOPRI5_B, _DOPRI5_B_ERR),
             "tsit5": (_TSIT5_C, _TSIT5_A, _TSIT5_B, _TSIT5_B_ERR)}


def _read_status(status: torch.Tensor) -> np.ndarray:
    """The (2,) float32 status on the host: one copy, one wait."""
    if status.device.type != "cuda":
        return status.numpy()
    host = torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
    host.copy_(status, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(status.device))
    done.synchronize()
    return host.numpy()


def odeint_adaptive(f: Callable, y0: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
                    atol: float = 1e-5, rtol: float = 1e-5, method: str = "tsit5",
                    max_steps: int = 1024, safety: float = 0.9, ifactor: float = 10.0,
                    dfactor: float = 0.2, h0: float = 0.01):
    """Integrate ``dy/dt = f(y, t)`` (``t`` a 0-d device tensor) from t0 to
    t1. Accept a step if the RMS of ``err / (atol + rtol * max(|y|, |y_new|))``
    is <= 1; next ``h = h_eff * clip(safety * err^(-1/5), dfactor, ifactor)``
    (torchdiffeq's controller); at most ``max_steps`` steps.

    Returns ``(y1, (n_accepted, n_rejected, t_reached))``, all device
    tensors; ``t_reached < t1`` means the budget ran out and ``y1`` is the
    state at ``t_reached``."""
    cs, a_rows, bs, b_errs = _TABLEAUS[method]
    n_stages = len(cs)
    dev = y0.device
    y = y0.float()
    scalar = lambda v, dtype=torch.float32: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
    t, t_end, h = scalar(t0), scalar(t1), scalar(h0)
    acc, rej = scalar(0, torch.int32), scalar(0, torch.int32)

    def one_step(y, t, h, k1):
        ks = [k1]
        for i in range(1, n_stages):
            yi = y + h * sum(a * k for a, k in zip(a_rows[i], ks) if a != 0.0)
            ks.append(f(yi, t + cs[i] * h))
        y_new = y + h * sum(b * k for b, k in zip(bs, ks) if b != 0.0)
        err = h * sum(be * k for be, k in zip(b_errs, ks) if be != 0.0)
        return y_new, err, ks[-1]  # FSAL: the last stage is f(y_new, t + h)

    k1 = f(y, t)
    for _ in range(max(1, -(-max_steps // CHUNK_STEPS))):
        for _ in range(CHUNK_STEPS):
            active = (t < t_end) & (acc + rej < max_steps)
            h_eff = torch.minimum(h, t_end - t)
            y_new, err, k_last = one_step(y, t, h_eff, k1)
            r = err / (atol + rtol * torch.maximum(y.abs(), y_new.abs()))
            en = torch.sqrt((r * r).mean())
            accept = (en <= 1.0) & active
            factor = torch.clamp(safety * en.clamp_min(1e-10) ** -0.2, dfactor, ifactor)
            h = torch.where(active, h_eff * factor, h)
            y = torch.where(accept, y_new, y)
            t = torch.where(accept, t + h_eff, t)
            k1 = torch.where(accept, k_last, k1)
            acc = acc + accept.to(torch.int32)
            rej = rej + (active & ~accept).to(torch.int32)
        done = (t >= t_end) | (acc + rej >= max_steps)
        status = _read_status(torch.stack([done.float(), t]))
        if status[0]:
            break
    if status[1] < t1:
        warnings.warn(
            f"odeint_adaptive: step budget exhausted at t={status[1]} < {t1} "
            "(accepted+rejected = max_steps); result is the state at t, not t1 - "
            "loosen atol/rtol or raise max_steps", stacklevel=2)
    return y, (acc, rej, t)


def sample_adaptive(apply_fn: Callable, cond_emb: torch.Tensor, dim_out: int,
                    rand_scale: float = 0.0, atol: float = 1e-5, rtol: float = 1e-5,
                    method: str = "tsit5", max_steps: int = 1024,
                    return_stats: bool = False, seed: int = 0,
                    y0: Optional[torch.Tensor] = None):
    """Adaptive counterpart of :func:`sample_midpoint` from t=0 to 1. With
    ``return_stats`` returns ``(y1, {"accepted", "rejected", "complete"})``
    (device tensors; ``complete`` is False when the budget ran out)."""
    B, L, _ = cond_emb.shape
    if y0 is None:
        y0 = initial_state((B, L, dim_out), rand_scale, seed, cond_emb.device)
    y1, (acc, rej, t) = odeint_adaptive(apply_fn, y0, atol=atol, rtol=rtol, method=method,
                                        max_steps=max_steps)
    if return_stats:
        return y1, {"accepted": acc, "rejected": rej, "complete": t >= 1.0}
    return y1
