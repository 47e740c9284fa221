"""sylber_tpu_torch: the PyTorch/CUDA port of sylber_tpu for NVIDIA Hopper.

Imports torch, never JAX, and nothing of ``sylber_tpu``. The hand-written
CUDA kernels under ``csrc/`` are built with nvcc at first use.
"""

from .api import Segmenter

__all__ = ["Segmenter"]
