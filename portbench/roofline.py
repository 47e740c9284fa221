"""Least times of the port's kernels from the shapes a run sent them.

Copied from ``chip_smoke.py`` (``bound_ms``, ``conv0_record``,
``attention_record``, ``segmentation_records``), keeping the bytes and
operations bounds only. A kernel's bound is the larger of its bytes over
the memory rate and its operations over the peak rate of its arithmetic;
each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

from typing import Sequence

from .flops import H100_BYTES_PER_S, H100_PEAK_FLOPS


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    return max(nbytes / H100_BYTES_PER_S, ops / H100_PEAK_FLOPS[dtype])


def conv0_bound_s(B: int, L: int, D: int, k: int, s: int, out_bytes: int) -> float:
    """Frontend layer 0 (conv, GroupNorm, GELU) on a (B, L) float32 batch:
    the waveform, the weight and the norm's affine read, the (B, T0, D)
    output written; ``2 k + 4`` fp32 operations an output."""
    t0 = (L - k) // s + 1
    nbytes = 4 * (B * L + D * (k + 2)) + B * t0 * D * out_bytes
    return bound_s(nbytes, B * t0 * D * (2 * k + 4), "float32")


def attention_bound_s(L: int, kv_len: Sequence[int], heads: int, head_dim: int,
                      elem_bytes: int, dtype: str) -> float:
    """One attention call on (B, H, L, D): q read and the output written in
    full, K and V up to each row's ``kv_len``; the scores and the weighted
    sum, 4 H D L sum(kv_len) operations."""
    B, kv = len(kv_len), int(sum(kv_len))
    nbytes = (2 * B * L + 2 * kv) * heads * head_dim * elem_bytes + 4 * B
    return bound_s(nbytes, 4.0 * heads * head_dim * L * kv, dtype)


def segmentation_bound_s(B: int, L: int, d: int) -> float:
    """Both passes of the segmentation on (B, L, d) float32 states, as one
    operation: the states, the norms and the voiced mask read once, the
    (B, L + 1, 2) int32 segments and the counts written once."""
    return (4 * B * L * d + 4 * B * L + B * L + 8 * B * (L + 1) + 4 * B) / H100_BYTES_PER_S


# An encoder call is (B, L, lengths): a padded (B, L) batch of rows holding
# ``lengths`` samples each; the readers sum the bounds over a trace's calls.

def frontend_calls_s(cfg, calls, out_bytes: int = 2) -> float:
    k, s = cfg["conv_kernel"][0], cfg["conv_stride"][0]
    return sum(conv0_bound_s(B, L, cfg["conv_dim"][0], k, s, out_bytes) for B, L, _ in calls)


def attention_calls_s(cfg, calls, frames, elem_bytes: int = 2,
                      dtype: str = "bfloat16") -> float:
    """Every layer's attention over each call, ``frames(n)`` the frame count
    of ``n`` samples."""
    H = cfg["num_attention_heads"]
    Dh = cfg["hidden_size"] // H
    return cfg["num_hidden_layers"] * sum(
        attention_bound_s(frames(L), [frames(n) for n in lengths], H, Dh, elem_bytes, dtype)
        for _, L, lengths in calls)


def segmentation_calls_s(cfg, calls, frames) -> float:
    return sum(segmentation_bound_s(B, frames(L), cfg["hidden_size"]) for B, L, _ in calls)
