"""The adaptive path of the port's ``SegmentSynthesis.sample`` (tsit5) on
the trained ``mini_synth.npz`` regressor against JAX's ``sample_adaptive``
on the CPU.

It completes, takes within a fifth of JAX's accepted plus rejected steps
and lands within 1e-2 of JAX's result. Its error estimate stands near the
float32 rounding of the trained field, so the step decisions follow the
GEMMs' summation order: 29 steps against JAX's 33 with one intra-op thread,
34 with the machine's threads. (The solver's own steps equal JAX's where
the estimate stands above rounding: ``test_torch_cfm.py``.)
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu import synthesis as jsyn
from sylber_tpu.flow.cfm import sample_adaptive as jax_sample_adaptive
from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config_from_dict
from sylber_tpu_torch import synthesis as tsyn

FIXTURES = Path(__file__).parent / "fixtures"


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def mini():
    mc = json.loads((FIXTURES / "mini_synth.json").read_text())["config"]["model"]
    trained = load_params_npz(str(FIXTURES / "mini_synth.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jax_synth = jsyn.SegmentSynthesis(config=jax_config_from_dict(mc), params=jsyn.SynthesisParams(
        enc, trained["input_mlp"], trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=tsyn.synthesis_config_from_dict(mc),
                                 params={"hubert": enc, **trained}, device="cpu")
    return jax_synth, port, float(mc["norm_threshold"])


@pytest.fixture
def one_thread():
    """Hundreds of regressor calls on tiny tensors: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_adaptive_path_close_to_jax(mini, one_thread):
    jax_synth, port, _ = mini
    cond_in = np.random.RandomState(2).randn(2, 29, 144).astype(np.float32)
    jcond = jax_synth._cond_from_features(jnp.asarray(cond_in))

    def field(x, t):
        return jax_synth.regressor.apply({"params": jax_synth.params.regressor}, x,
                                         jnp.asarray(t), cond_emb=jcond)

    want, jst = jax.jit(lambda c: jax_sample_adaptive(
        field, jax.random.PRNGKey(0), c, 14, method="tsit5", return_stats=True))(jcond)
    cond = port.cond_from_features(torch.from_numpy(cond_in))
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-5)
    got, st = port.sample(cond, method="tsit5", return_stats=True)
    want = np.asarray(want).copy()
    want[..., 12] /= 5.0
    assert bool(st["complete"]) and bool(jst["complete"])
    steps = lambda s: int(s["accepted"]) + int(s["rejected"])  # noqa: E731
    assert abs(steps(st) - steps(jst)) <= 0.2 * steps(jst), (st, jst)
    assert _rel(got.numpy(), want) <= 1e-2
