"""The segmentation kernels' CUDA source run on the CPU, at 384 features and
more (``segment_scan.cu`` through the g++ stand-in of ``tests/cuda_emu``):
each case held to the plain versions exactly, the numpy oracle and the JAX
``segment_batch``, as ``test_torch_cuda_emu_segment.py``'s narrower cases
are. A file of its own so that a distributed run spreads the cases over
two workers.
"""

import pytest

from test_torch_cuda_emu_segment import (SEGMENT_CASES, WIDE, check_segmentation,  # noqa: F401
                                         emulated, segment_launch)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

WIDE_CASES = [c for c in SEGMENT_CASES if c[0] in WIDE]


@pytest.mark.parametrize("name,seed,L,d,lens", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_emulated_segmentation_matches_oracle_and_jax(segment_launch, name, seed, L, d, lens):
    check_segmentation(segment_launch, name, seed, L, d, lens)
