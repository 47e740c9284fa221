"""Tests of the benchmark harness. No JAX here: the harness, its reference
and the program's port are plain PyTorch.

Tests that need a CUDA card carry the ``cuda`` marker and skip inside the
test, with a reason, where there is none; run them on the card with
``python3 -m pytest portbench/tests -m cuda``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips with a reason without one")


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip with the reason (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
