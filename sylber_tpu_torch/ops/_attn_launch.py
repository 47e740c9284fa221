"""What the two attention wrappers share: checks, strides, the launch.

Both kernels take ``q``, ``k``, ``v`` of shape (B, H, L, D) addressed by
(batch, head, row) element strides with a dense last dimension, so a
``(B, L, H, D)`` projection viewed as ``(B, H, L, D)`` goes in without a
copy, and the output comes back in the layout ``q`` has. The wrapper runs
once per encoder layer beside kernels of tens of microseconds, so it keeps
its own work on the host short.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import check, device_of, lib, require_cuda, stream_of

_Strides = ctypes.c_longlong * 12
_DTYPES = (torch.float32, torch.bfloat16)


def _row_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(3) == 1 else t.contiguous()


def empty_like_heads(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, L, D) output: a view of (B, L, H, D) memory
    where ``q``'s heads lie side by side in a row (a view of a (B, L, H, D)
    projection, or of a (B, L, 3, H, D) fused q/k/v one), contiguous
    otherwise."""
    B, H, L, D = q.shape
    if q.stride(1) == D and q.stride(3) == 1:
        return q.new_empty((B, L, H, D)).transpose(1, 2)
    return q.new_empty((B, H, L, D))


def launch_attention(entry: str, name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, kv_len: torch.Tensor, scale: float,
                     max_seq: int, max_head_dim: int) -> torch.Tensor:
    """Check the arguments, launch ``entry`` of the kernel library on
    ``q``'s stream and return the (B, H, L, D) output."""
    shape = q.shape
    B, H, L, D = shape
    if L > max_seq or D > max_head_dim:
        raise ValueError(f"{name}: L={L} (limit {max_seq}) or D={D} "
                         f"(limit {max_head_dim}) is out of range")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != shape or v.shape != shape:
        raise ValueError(f"{name}: q, k, v shapes differ")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"{name}: kv_len must be (B,) int32")
    require_cuda(name, q, k, v, kv_len, contiguous=False)
    q, k, v, kv_len = _row_dense(q), _row_dense(k), _row_dense(v), kv_len.contiguous()
    out = empty_like_heads(q)
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *out.stride()[:3])
    with device_of(q):
        check(getattr(lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, H, L, D, strides, scale,
            q.dtype == torch.bfloat16, stream_of(q)), name)
    return out
