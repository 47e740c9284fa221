"""torch's intra-op threads while a port test file runs: two.

A distributed run gives each worker process a file at a time; torch would
start a thread a core in each of them, and the workers would then contend
for the cores. A test module takes the cap by importing the fixture:
``from _torch_threads import _few_threads  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
