"""The command without a card, and in a directory with the benchmark alone:
a non-zero exit and no result line."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = ["-m", "portbench.run", "--workload", "seg-corpus-b64", "--seed", "3000000017",
        "--seconds", "1", "--trace", "0"]


def _no_result(proc):
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.lstrip().startswith("{")]


def test_without_a_card_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test is of a machine without one")
    proc = subprocess.run([sys.executable, *ARGS], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    _no_result(proc)
    assert "needs 1 CUDA device" in proc.stderr


def test_with_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True,
                          text=True, env=env)
    _no_result(proc)
