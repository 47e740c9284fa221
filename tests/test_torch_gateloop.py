"""The port's GateLoop layers against the JAX package, on the CPU, fp32.

- the operator: the plain version (the kernel's chunked scan, the CPU
  path) and the scan (JAX's ``associative_scan`` recursion in torch ops)
  against ``gate_loop_operator`` and the float64 ``gate_loop_operator_ref``,
  the plain version also at the regressor's B8 L265 and B1 L1015, width
  512 (against JAX jitted); the scan is bit-equal to JAX's, the chunked
  order rounds otherwise (seen: 1.5e-7 of
  the largest against JAX at L 37, 7.9e-8 at L 1,015 D16, 1.7e-7 at B8
  L265 D512, 1.3e-7 at B1 L1015 D512; held at 1e-6); causal, as
  ``tests/unit/test_gateloop_adaptive.py`` checks JAX's; the scan's
  gradient against ``jax.grad``;
- ``SimpleGateLoop`` and ``Regressor(use_gateloop_layers=True)`` at
  ``test_gateloop_adaptive.py``'s configuration with JAX's weights carried
  over; the ``gateloop_{i}`` leaves' carry round trip bit for bit.

A synthesis train step with gateloop layers is ``test_torch_gateloop_step.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.models import voicebox as jvb
from sylber_tpu.ops.gateloop import gate_loop_operator, gate_loop_operator_ref
from sylber_tpu_torch.io.checkpoint import (state_dict_from_tree, synthesis_state_dict_from_jax,
                                            tree_from_state_dict)
from sylber_tpu_torch.models import voicebox as tvb
from sylber_tpu_torch.ops import gateloop as port_gateloop
from test_torch_synthesis_train import flat
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

# test_gateloop_adaptive.py's wiring configuration
TINY = dict(dim=32, depth=2, heads=2, dim_head=8, dim_in_proj=8, dim_cond_emb=16,
            num_register_tokens=2, use_gateloop_layers=True)
WALK_RTOL = 1e-6  # the chunked order against the scan, of the output's largest magnitude
# The random-init regressor at the softmax scale of 10 amplifies rounding: at
# TINY, JAX's own jitted output lies 1.6e-4 of the largest from its op-by-op
# one (2.0e-4 without the gateloop layers), and the port's 1.6e-4 from the
# jitted one. The gateloop layers alone are held at 1e-5 above.
TINY_RTOL = 4e-4


def _operands(B, L, D, seed):
    rng = np.random.RandomState(seed)
    q, kv = rng.randn(2, B, L, D).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.randn(B, L, D)))).astype(np.float32)
    return q, kv, a


@pytest.mark.parametrize("B,L,D", [(2, 37, 5), (1, 1015, 16), (3, 1, 4)])
def test_operator_matches_jax_and_the_float64_walk(B, L, D):
    q, kv, a = _operands(B, L, D, seed=L)
    want = np.asarray(gate_loop_operator(*map(jnp.asarray, (q, kv, a))))
    ref = gate_loop_operator_ref(q, kv, a)
    tq, tkv, ta = map(torch.from_numpy, (q, kv, a))
    scan = port_gateloop.gate_loop_scan(tq, tkv, ta).numpy()
    plain = port_gateloop.gate_loop_operator_plain(tq, tkv, ta).numpy()
    np.testing.assert_array_equal(scan, want)
    assert torch.equal(port_gateloop.gate_loop_operator(tq, tkv, ta), torch.from_numpy(plain))
    scale = np.abs(ref).max()
    for got in (scan, plain):
        np.testing.assert_allclose(got, ref, rtol=0, atol=WALK_RTOL * scale)
    np.testing.assert_allclose(plain, want, rtol=0, atol=WALK_RTOL * scale)


@pytest.mark.parametrize("B,L,D", [(8, 265, 512), (1, 1015, 512)])
def test_plain_matches_jax_at_the_regressor_lengths(B, L, D):
    """The chunked plain version (the CPU path) against JAX's scan, jitted
    (op by op it takes seconds at this size), and the float64 walk."""
    q, kv, a = _operands(B, L, D, seed=L)
    want = np.asarray(jax.jit(gate_loop_operator)(*map(jnp.asarray, (q, kv, a))))
    ref = gate_loop_operator_ref(q, kv, a)
    got = port_gateloop.gate_loop_operator(*map(torch.from_numpy, (q, kv, a))).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=WALK_RTOL * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=WALK_RTOL * scale)


@pytest.mark.parametrize("form", ["walk", "scan"])
def test_operator_is_causal(form):
    rng = np.random.RandomState(1)
    q, kv = rng.randn(2, 1, 24, 4).astype(np.float32)
    a = 0.5 * np.ones((1, 24, 4), np.float32)
    fn = (port_gateloop.gate_loop_operator_plain if form == "walk"
          else port_gateloop.gate_loop_scan)
    full = fn(*map(torch.from_numpy, (q, kv, a))).numpy()
    kv2 = kv.copy()
    kv2[:, 12:] += 100.0
    pert = fn(*map(torch.from_numpy, (q, kv2, a))).numpy()
    np.testing.assert_array_equal(full[:, :12], pert[:, :12])
    assert np.abs(full[:, 12:] - pert[:, 12:]).max() > 1.0


def test_scan_gradient_matches_jax_grad():
    q, kv, a = _operands(2, 29, 6, seed=5)
    w = np.random.RandomState(6).randn(2, 29, 6).astype(np.float32)
    jg = jax.grad(lambda q, kv, a: (gate_loop_operator(q, kv, a) * w).sum(),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, kv, a)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, kv, a)]
    (port_gateloop.gate_loop_operator(*ts) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(g)).max())


def test_simple_gateloop_module_matches_jax():
    x = np.random.RandomState(3).randn(3, 9, 16).astype(np.float32)
    module = jvb.SimpleGateLoop(16)
    params = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    port = tvb.SimpleGateLoop(16)
    port.load_state_dict(state_dict_from_tree(params))
    assert port.post_ln.eps == 1e-6
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    scan = port(torch.from_numpy(x).requires_grad_()).detach().numpy()  # autograd: the scan
    np.testing.assert_allclose(scan, want, rtol=0, atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=1)
def _tiny_params():
    cfg = jvb.RegressorConfig(**TINY)
    x = jnp.asarray(np.random.RandomState(2).randn(2, 11, 14), jnp.float32)
    emb = jnp.zeros((2, 11, 16))
    return jax.device_get(jax.jit(jvb.Regressor(cfg).init)(
        jax.random.PRNGKey(0), x, jnp.zeros((2,)), cond_emb=emb)["params"])


def test_gateloop_regressor_matches_jax():
    params = _tiny_params()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 11, 14).astype(np.float32)
    emb = rng.randn(2, 11, 16).astype(np.float32)
    times = np.array([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(jvb.Regressor(jvb.RegressorConfig(**TINY)).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(times), cond_emb=jnp.asarray(emb)))
    port = tvb.Regressor(tvb.RegressorConfig(**TINY))
    port.load_state_dict(synthesis_state_dict_from_jax(
        {"regressor": params, "input_mlp": {}})["regressor"])
    assert isinstance(port.transformer.gateloop_1, tvb.SimpleGateLoop)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(times),
                   cond_emb=torch.from_numpy(emb)).numpy()
    assert got.shape == (2, 11, 14) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TINY_RTOL * np.abs(want).max())


def test_gateloop_leaves_carry_bit_exact():
    params = _tiny_params()
    sd = synthesis_state_dict_from_jax({"regressor": params, "input_mlp": {}})["regressor"]
    model = tvb.Regressor(tvb.RegressorConfig(**TINY))
    model.load_state_dict(sd)  # every leaf has its slot, and every slot a leaf
    assert {k for k in sd if "gateloop_0" in k} == {
        "transformer.gateloop_0.norm.gamma", "transformer.gateloop_0.to_qkva.weight",
        "transformer.gateloop_0.post_ln.weight", "transformer.gateloop_0.post_ln.bias"}
    back, want = flat(tree_from_state_dict(model.state_dict())), flat(params)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
