"""The vocoder proof's ``main`` (``sylber_tpu_torch/vocoder_proof.py``) on
the CPU at a tiny width (the generator 32 wide, 0.1 s crops; the
discriminators at their width): 2 steps with the whole train state written,
then a resume and 1 step, give the parameters and Adam moments of 3
uninterrupted steps bit for bit; the recorded ``.json``'s keys and the
float16 generator (read by the JAX package) are written under ``--out-dir``
only, nothing under ``tests/fixtures``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu_torch import vocoder_proof as vp
from sylber_tpu_torch.io.checkpoint import generator_state_dict_from_jax

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture
def tiny(monkeypatch):
    """A 32-wide generator on 0.1 s crops (5 frames)."""
    monkeypatch.setattr(vp, "GEN_CFG", dict(vp.GEN_CFG, upsample_initial_channel=32))
    monkeypatch.setattr(vp, "SECONDS", 0.1)
    monkeypatch.setattr(vp, "FRAMES", 5)


def _run(tmp_path, name, steps, *extra):
    return vp.main(["--steps", str(steps), "--batch-size", "1", "--n-utts", "4",
                    "--save-every", "0", "--log-every", "1", "--skip-gates",
                    "--out-dir", str(tmp_path / name), "--device", "cpu", *extra])


def test_a_resumed_run_gives_the_uninterrupted_parameters(tiny, tmp_path, monkeypatch):
    torch.set_num_threads(2)
    before = {p.name: p.stat().st_mtime_ns for p in FIXTURES.iterdir()}
    monkeypatch.chdir(tmp_path)
    whole = _run(tmp_path, "whole", 3)
    _run(tmp_path, "first", 2, "--state-out", str(tmp_path / "state.pt"))
    resumed = _run(tmp_path, "second", 1, "--resume-from", str(tmp_path / "state.pt"))
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 3
    for name in ("generator", "mpd", "msd"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    for opt in ("opt_gen", "opt_disc"):
        sa, sb = getattr(a, opt).state_dict()["state"], getattr(b, opt).state_dict()["state"]
        assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa), opt
    meta = json.loads((tmp_path / "second" / "mini_vocoder.json").read_text())
    recorded = json.loads((FIXTURES / "mini_vocoder.json").read_text())
    assert set(recorded) <= set(meta) and set(recorded["eval"]) == set(meta["eval"])
    assert meta["train"]["steps"] == 3 and meta["eval_random_init"] == whole["eval_random_init"]
    # the generator as the fixtures hold it: float16, read by the JAX package
    tree = jax_load_npz(str(tmp_path / "second" / "mini_vocoder.npz"))
    assert np.load(tmp_path / "second" / "mini_vocoder.npz")["conv_pre/kernel"].dtype == \
        np.float16
    np.testing.assert_allclose(
        generator_state_dict_from_jax(tree)["conv_pre.weight"].numpy(),
        b.generator.state_dict()["conv_pre.weight"].half().float().numpy())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["first", "second", "state.pt",
                                                          "whole"]
    assert {p.name: p.stat().st_mtime_ns for p in FIXTURES.iterdir()} == before
