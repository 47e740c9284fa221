"""FLOPs of a distillation step, model FLOP utilisation on an H100, traces.

Port of ``sylber_tpu/utils/profiling.py``. ``hubert_train_flops`` counts the
conv frontend and the transformer matmuls of one step (teacher forward
once, student forward and backward three times). ``mfu`` divides the rate
by the H100's dense peak for the step's arithmetic: NVIDIA's H100 SXM data
sheet figures, 989 TFLOP/s bf16 on the tensor cores, 495 TF32 and 67 fp32
outside the tensor cores. ``trace`` records a block with ``torch.profiler``
into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

# H100 SXM data sheet, dense, at the 700 W power limit
H100_PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def hubert_train_flops(config, batch_size: int, num_samples: int) -> float:
    """Approximate FLOPs of one distillation step on ``batch_size`` crops of
    ``num_samples`` samples."""
    frames = config.feat_extract_output_length(num_samples)
    conv = 0.0
    length, in_ch = num_samples, 1
    for ch, k, s in zip(config.conv_dim, config.conv_kernel, config.conv_stride):
        length = (length - k) // s + 1
        conv += 2.0 * length * ch * in_ch * k
        in_ch = ch
    d, f = config.hidden_size, config.intermediate_size
    per_layer = (2.0 * frames * d * d * 4            # q, k, v and out projections
                 + 2.0 * frames * frames * d * 2     # scores and weighted sum
                 + 2.0 * frames * d * f * 2)         # FFN
    proj = 2.0 * frames * config.conv_dim[-1] * d
    pos = (2.0 * frames * d * (d // config.num_conv_pos_embedding_groups)
           * config.num_conv_pos_embeddings)
    fwd = conv + proj + pos + per_layer * config.num_hidden_layers
    return batch_size * fwd * 4.0


def peak_flops(dtype: str, precision: str = "highest") -> float:
    """The H100's dense peak for a model in ``dtype`` at ``precision``:
    bf16 on the tensor cores, fp32 as TF32 under ``"default"`` precision,
    else fp32 on the CUDA cores."""
    if dtype == "bfloat16":
        return H100_PEAK_FLOPS["bfloat16"]
    return H100_PEAK_FLOPS["tf32" if precision != "highest" else "float32"]


def mfu(step_flops: float, step_time_s: float, dtype: str,
        precision: str = "highest", n_chips: int = 1) -> float:
    """The share of ``n_chips`` cards' peak that a step of ``step_flops``
    in ``step_time_s`` reaches."""
    return step_flops / max(step_time_s, 1e-9) / (peak_flops(dtype, precision) * n_chips)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (the host's operators, and
    the device's kernels and copies where a GPU is present) and write it as
    a Chrome trace to ``<log_dir>/trace.json`` (open it in Perfetto or
    ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
