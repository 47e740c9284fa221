"""GateLoop: the data-dependent gated linear recurrence of the voicebox
regressor's optional ``SimpleGateLoop`` layers.

Port of ``sylber_tpu/ops/gateloop.py``. Per channel,

    s_t = a_t * s_{t-1} + kv_t   (s_{-1} = 0, a_t in (0, 1)),   o_t = q_t * s_t.

- :func:`gate_loop_operator_plain` is the kernel's plain version (the CPU
  path, and the card check's reference): a chunked scan in torch ops. Time
  is cut into chunks of :data:`CHUNK` steps; each chunk is walked from a zero
  state beside the product of its gates, the chunks' carries are combined in
  chunk order, and each chunk is walked again from its carry-in. It rounds
  as ``csrc/gateloop.cu`` does, operation for operation, so the kernel is
  bit-equal to it; its loop is ``2 CHUNK + L / CHUNK`` vectorised steps;
- :func:`gate_loop_scan` is JAX's own algorithm, ``lax.associative_scan``'s
  odd/even recursion over the monoid ``(a1, kv1) . (a2, kv2) = (a1 a2,
  a2 kv1 + kv2)``, in torch ops: differentiable, so the synthesis trainers
  take it under autograd, as the attention takes ``attention_xla``;
- :func:`gate_loop_operator` dispatches: the scan where autograd records,
  the kernel of ``csrc/gateloop.cu`` for other CUDA tensors, the plain
  version on the CPU.

The scan and the chunked order round differently: they agree to about 2e-7
of the output's largest magnitude at the regressor's lengths (the tests
state the gap they measure and hold it at 1e-6).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import check, lib, require_cuda, stream_of

_Strides = ctypes.c_longlong * 6


CHUNK = 16  # time steps a chunk: CH of csrc/gateloop.cu


def gate_loop_operator_plain(q: torch.Tensor, kv: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, L, D) float32: the recurrence as a chunked scan, in the kernel's
    order and roundings."""
    q, kv, a = q.float(), kv.float(), a.float()
    B, L, D = q.shape
    n = -(-L // CHUNK)

    def chunks(x, fill):  # (B, n, CHUNK, D), the last chunk padded with `fill`
        pad = x.new_full((B, n * CHUNK - L, D), fill)
        return torch.cat([x, pad], dim=1).view(B, n, CHUNK, D)

    qc, kc, ac = chunks(q, 0.0), chunks(kv, 0.0), chunks(a, 1.0)
    s, p = q.new_zeros(B, n, D), q.new_ones(B, n, D)
    for j in range(CHUNK):  # phase 1: each chunk from a zero state
        s = ac[:, :, j] * s + kc[:, :, j]
        p = p * ac[:, :, j]
    carry = q.new_zeros(B, n, D)
    for c in range(1, n):  # phase 2: the carries in chunk order
        carry[:, c] = p[:, c - 1] * carry[:, c - 1] + s[:, c - 1]
    out = q.new_empty(B, n, CHUNK, D)
    s = carry
    for j in range(CHUNK):  # phase 3: each chunk from its carry-in
        s = ac[:, :, j] * s + kc[:, :, j]
        out[:, :, j] = qc[:, :, j] * s
    return out.view(B, n * CHUNK, D)[:, :L].contiguous()


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (``len(even)`` is
    ``len(odd)`` or one more)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n else pairs


def _scan(a: torch.Tensor, kv: torch.Tensor):
    """``lax.associative_scan`` of the (a, kv) pairs along dim 1, recursion
    and combine order as JAX's (``jax/_src/lax/control_flow/loops.py``)."""
    n = a.shape[1]
    if n < 2:
        return a, kv

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]

    ra, rkv = combine((a[:, 0:-1:2], kv[:, 0:-1:2]), (a[:, 1::2], kv[:, 1::2]))
    oa, okv = _scan(ra, rkv)
    if n % 2 == 0:
        ea, ekv = combine((oa[:, :-1], okv[:, :-1]), (a[:, 2::2], kv[:, 2::2]))
    else:
        ea, ekv = combine((oa, okv), (a[:, 2::2], kv[:, 2::2]))
    ea, ekv = torch.cat([a[:, :1], ea], dim=1), torch.cat([kv[:, :1], ekv], dim=1)
    return _interleave(ea, oa), _interleave(ekv, okv)


def gate_loop_scan(q: torch.Tensor, kv: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, L, D) float32: the recurrence as JAX evaluates it (a log-depth
    associative scan), differentiable."""
    _, state = _scan(a.float(), kv.float())
    return q.float() * state


def gate_loop_operator(q: torch.Tensor, kv: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, L, D) float32 output of the recurrence over (B, L, D) ``q``,
    ``kv``, ``a`` (float32; any (batch, time) strides with a dense last
    dimension, such as thirds of one (B, L, 3D) product)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kv, a)):
        return gate_loop_scan(q, kv, a)
    if q.device.type == "cpu":
        return gate_loop_operator_plain(q, kv, a)
    B, L, D = q.shape
    if any(t.dtype != torch.float32 for t in (q, kv, a)) or kv.shape != q.shape \
            or a.shape != q.shape:
        raise ValueError("gate_loop_operator: q, kv, a must be float32 of one (B, L, D) shape")
    require_cuda("gate_loop_operator", q, kv, a, contiguous=False)
    q, kv, a = (t if t.stride(2) == 1 else t.contiguous() for t in (q, kv, a))
    return _launch(q, kv, a)


def _launch(q: torch.Tensor, kv: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    B, L, D = q.shape
    out = torch.empty(B, L, D, dtype=torch.float32, device=q.device)
    strides = _Strides(*q.stride()[:2], *kv.stride()[:2], *a.stride()[:2])
    check(lib().sylber_gate_loop(q.data_ptr(), kv.data_ptr(), a.data_ptr(), out.data_ptr(),
                                 B, L, D, strides, stream_of(q)), "gate_loop_operator")
    gate_loop_operator.launches += 1
    return out


gate_loop_operator.launches = 0
