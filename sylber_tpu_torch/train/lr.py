"""Learning-rate schedule: linear warmup, hold, then cosine to a floor.

Port of ``sylber_tpu/train/lr.py::cosine_warmup_schedule``. The schedule is
evaluated on the host (the trainer knows its update count), in float32
arithmetic as the JAX function traces it, so the optimizer receives a
Python float and the step never reads the device.
"""

from __future__ import annotations

import numpy as np


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_factor: float = 0.05, hold_steps: int = 0):
    """Returns ``update_count -> lr``: ``step / warmup`` below ``warmup_steps``,
    then (after ``hold_steps`` at the peak) a cosine from 1 to ``min_factor``
    over ``total_steps``, and ``min_factor`` beyond."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            factor = s / np.maximum(f32(1.0), f32(warmup_steps))
        elif s > total_steps + hold_steps + warmup_steps:
            factor = f32(min_factor)
        else:
            net = np.maximum(f32(0.0), s - f32(warmup_steps) - f32(hold_steps))
            cos = np.cos(net / f32(max(1, total_steps)) * f32(np.pi))
            factor = f32(min_factor) + f32(1.0 - min_factor) * (f32(1.0) + cos) / f32(2.0)
        return float(f32(base_lr) * f32(factor))

    return schedule
