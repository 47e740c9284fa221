"""The port's CFM samplers (``sylber_tpu_torch/flow/cfm.py``) against
``sylber_tpu/flow/cfm.py`` on the CPU.

The cases of ``tests/unit/test_flow.py``'s samplers and of
``tests/unit/test_gateloop_adaptive.py``'s adaptive solver, run on both
packages side by side with JAX's own y0 passed in:

- the fixed grid equals ``jnp.linspace`` bit for bit, and euler / midpoint
  / rk4 give JAX's result within 2e-7 of the largest;
- dopri5 and tsit5 take the same accepted and rejected steps and reach
  the same ``t`` (also when the step budget runs out, with JAX's warning;
  ``t_reached`` then within 1e-4), the state within 1e-6 of the largest
  (1e-5 on a nonlinear field); the
  chunked controller gives the same result at every chunk length (a step
  past the end changes nothing);
- on a voicebox ``Regressor`` field the adaptive sampler lands where JAX's
  and a dense fixed grid (400 points) do, as JAX's test asks (rtol 1e-2,
  atol 2e-3).

Where the embedded error estimate sits at the float32 rounding of the field
(tolerances of 1e-8 on values of order 1), the two packages' step decisions
are noise and are not compared; the port is held to JAX's own test there
(it must reject, and stay finite).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.flow import cfm as J
from sylber_tpu.models.voicebox import Regressor as JRegressor
from sylber_tpu.models.voicebox import RegressorConfig as JRegressorConfig
from sylber_tpu_torch.flow import cfm as T
from sylber_tpu_torch.io.checkpoint import state_dict_from_tree
from sylber_tpu_torch.models.voicebox import Regressor, RegressorConfig


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def test_time_grid_is_jnp_linspace():
    for steps in (2, 3, 5, 6, 8, 9, 16, 17, 20, 33, 50, 51, 64, 100, 128, 257):
        np.testing.assert_array_equal(T.time_grid(steps), np.asarray(jnp.linspace(0.0, 1.0, steps)))


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_fixed_grid_samplers_match_jax(method):
    y0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 3, 14))) * np.float32(0.7)
    cond = np.zeros((2, 3, 14), np.float32)

    def jfield(x, t):
        return jnp.cos(t) * x - 0.5 * jnp.tanh(x) + 1.0

    def tfield(x, t):
        return float(np.cos(np.float32(t))) * x - 0.5 * torch.tanh(x) + 1.0

    want = J.sample_midpoint(jfield, jax.random.PRNGKey(0), jnp.asarray(cond), 14, steps=7,
                             rand_scale=0.7, method=method)
    got = T.sample_midpoint(tfield, torch.from_numpy(cond), 14, steps=7, method=method,
                            y0=torch.from_numpy(y0))
    assert _rel(got, want) <= 2e-7


def test_midpoint_exponential_flow_and_steps1():
    """dx/dt = x from y0 over [0, 1] -> e * y0, second order in the steps;
    ``steps=1`` returns y0 (the seeded draw, rand_scale applied)."""
    cond = torch.zeros(2, 3, 14)
    coarse = T.sample_midpoint(lambda x, t: x, cond, 14, steps=5, rand_scale=1.0, seed=3)
    fine = T.sample_midpoint(lambda x, t: x, cond, 14, steps=60, rand_scale=1.0, seed=3)
    y0 = T.initial_state((2, 3, 14), 1.0, 3, "cpu")
    np.testing.assert_allclose(fine.numpy(), np.e * y0.numpy(), rtol=2e-3)
    assert (coarse - np.e * y0).abs().max() > (fine - np.e * y0).abs().max()
    once = T.sample_midpoint(lambda x, t: x * 100, torch.zeros(1, 4, 14), 14, steps=1,
                             rand_scale=0.7, seed=5)
    assert torch.equal(once, T.initial_state((1, 4, 14), 0.7, 5, "cpu"))
    assert torch.equal(T.initial_state((1, 2, 3), 0.0, 5, "cpu"), torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="unknown ODE method"):
        T.sample_midpoint(lambda x, t: x, cond, 14, steps=3, method="heun")


def _adaptive_both(jf, tf, y0, **kw):
    jy, (ja, jr, jt) = J.odeint_adaptive(jf, jnp.asarray(y0), **kw)
    ty, (ta, tr, tt) = T.odeint_adaptive(tf, torch.from_numpy(y0), **kw)
    return (np.asarray(jy), int(ja), int(jr), float(jt)), (ty.numpy(), int(ta), int(tr), float(tt))


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_adaptive_linear_ode_matches_jax(method):
    """dy/dt = -2y: y(1) = y0 exp(-2), and JAX's steps."""
    y0 = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    j, t = _adaptive_both(lambda y, s: -2.0 * y, lambda y, s: -2.0 * y, y0,
                          atol=1e-6, rtol=1e-6, method=method)
    np.testing.assert_allclose(t[0], y0 * np.exp(-2.0), rtol=1e-4, atol=1e-6)
    assert t[1:] == j[1:] and t[1] > 0
    assert _rel(t[0], j[0]) <= 1e-6


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_adaptive_nonlinear_matches_jax_and_fine_rk4(method):
    def fnp(y, t):
        return np.sin(3.0 * t) * y - 0.5 * np.tanh(y)

    y0 = np.random.RandomState(5).randn(2, 7).astype(np.float32)
    ts = np.linspace(0.0, 1.0, 2001)
    y = y0.astype(np.float64)
    for t0, t1 in zip(ts[:-1], ts[1:]):  # dense classical RK4
        h = t1 - t0
        k1 = fnp(y, t0)
        k2 = fnp(y + h / 2 * k1, t0 + h / 2)
        k3 = fnp(y + h / 2 * k2, t0 + h / 2)
        k4 = fnp(y + h * k3, t1)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    j, t = _adaptive_both(lambda v, s: jnp.sin(3.0 * s) * v - 0.5 * jnp.tanh(v),
                          lambda v, s: torch.sin(3.0 * s) * v - 0.5 * torch.tanh(v), y0,
                          atol=1e-5, rtol=1e-5, method=method)
    np.testing.assert_allclose(t[0], y, rtol=1e-3, atol=1e-5)
    assert t[1:] == j[1:] and t[1] + t[2] < 200
    assert _rel(t[0], j[0]) <= 1e-5


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_budget_exhausted_matches_jax_and_warns(method):
    """Out of steps on a stiff field, with a large first step so that the
    controller rejects and accepts on error estimates far above rounding:
    JAX's counts, t_reached within 1e-4 (the packages round the stage sums
    an ulp or two apart, and the error estimate's weights, up to 13 in
    tsit5's tableau, cancel), the state at it within 1e-4 of the largest,
    and a warning from the read that ends the loop."""
    y0 = np.random.RandomState(6).randn(4).astype(np.float32)
    with pytest.warns(UserWarning, match="step budget exhausted"):
        j, t = _adaptive_both(lambda v, s: -30.0 * (v - jnp.cos(s)),
                              lambda v, s: -30.0 * (v - torch.cos(s)), y0,
                              atol=1e-3, rtol=1e-3, method=method, max_steps=4, h0=0.3)
    assert t[1:3] == j[1:3] == (2, 2)
    assert abs(t[3] - j[3]) <= 1e-4 * j[3] and j[3] < 1.0
    assert _rel(t[0], j[0]) <= 1e-4


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunk_length_changes_nothing(chunk, monkeypatch):
    """Masked steps past the end leave the state, t and the counts alone."""
    y0 = torch.from_numpy(np.random.RandomState(7).randn(2, 5).astype(np.float32))
    f = lambda v, s: torch.cos(2.0 * s) * v - 0.3 * v ** 3  # noqa: E731
    ref = T.odeint_adaptive(f, y0, atol=1e-6, rtol=1e-6)
    monkeypatch.setattr(T, "CHUNK_STEPS", chunk)
    got = T.odeint_adaptive(f, y0, atol=1e-6, rtol=1e-6)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))


def test_adaptive_rejects_on_tight_tolerance():
    """JAX's own case: a huge first step at a tolerance below float32
    rounding must be rejected and shrunk, and the result stay finite."""
    y1, (acc, rej, t) = T.odeint_adaptive(
        lambda y, s: torch.cos(40.0 * s) * (1.0 + y * y) * 0.1, torch.ones(4),
        atol=1e-8, rtol=1e-8, h0=1.0)
    assert int(rej) > 0 and torch.isfinite(y1).all() and float(t) == 1.0


@pytest.fixture
def one_thread():
    """Hundreds of regressor calls on tiny tensors: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sample_adaptive_on_a_regressor_matches_dense_and_jax(one_thread):
    cfg_kw = dict(dim=32, depth=1, heads=2, dim_head=8, dim_in_proj=8, dim_cond_emb=16,
                  num_register_tokens=0, dim_out=6)
    jmodel = JRegressor(JRegressorConfig(**cfg_kw))
    cond = np.random.RandomState(6).randn(2, 13, 16).astype(np.float32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), jnp.zeros((2, 13, 6)),
                                        jnp.zeros((2,)), cond_emb=jnp.asarray(cond))["params"])
    port = Regressor(RegressorConfig(**cfg_kw))
    port.load_state_dict(state_dict_from_tree(params))

    def jfield(x, t):
        return jmodel.apply({"params": params}, x, jnp.asarray(t), cond_emb=jnp.asarray(cond))

    def tfield(x, t):
        return port(x, t, cond_emb=torch.from_numpy(cond))

    rng = jax.random.PRNGKey(7)
    y0 = torch.from_numpy(np.asarray(jax.random.normal(rng, (2, 13, 6))) * np.float32(0.7))
    want, jst = jax.jit(lambda c: J.sample_adaptive(jfield, rng, c, 6, rand_scale=0.7,
                                                    return_stats=True))(jnp.asarray(cond))
    dense = jax.jit(lambda c: J.sample_midpoint(jfield, rng, c, 6, steps=400,
                                                rand_scale=0.7))(jnp.asarray(cond))
    with torch.no_grad():
        got, st = T.sample_adaptive(tfield, torch.from_numpy(cond), 6, return_stats=True, y0=y0)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=2e-3)
    assert bool(st["complete"]) and bool(jst["complete"])
    assert int(st["accepted"]) + int(st["rejected"]) < 100
