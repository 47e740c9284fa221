"""One synthesis train step of a regressor with GateLoop layers against
``sylber_tpu/synthesis.py`` run op by op (``jax.disable_jit``, as
``test_torch_synthesis_train.py`` explains), on the CPU, fp32.

The trained ``mini_synth.npz`` regressor with gateloop layers added (the
gateloop leaves of a JAX init of that configuration): the loss within rtol
1e-5 and every gradient leaf within 1e-4 of the largest gradient (seen:
equal losses, 3.2e-6 at layer 0's ``to_qkv``), the gateloop layers' own
gradients nonzero. JAX's scan under its gradient, the port's scan
(``ops/gateloop.py::gate_loop_scan``) under autograd. A file of its own:
JAX's op-by-op gradient takes about half a minute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu import synthesis as jsyn
from sylber_tpu.models import voicebox as jvb
from sylber_tpu_torch import synthesis as tsyn
from test_torch_synthesis_train import (GRAD_RTOL, LOSS_RTOL, _few_threads,  # noqa: F401
                                        batch_of, flat, jax_draws, pair, port_grad_tree,
                                        worst_leaf)


@pytest.fixture(scope="module")
def gateloop_mini():
    """``mini_synth``'s trained pair with gateloop layers added: the trained
    leaves, and the gateloop leaves of a JAX init of that configuration."""
    jsynth, port = pair("mini_synth")
    jcfg = dataclasses.replace(jsynth.config, regressor=dataclasses.replace(
        jsynth.config.regressor, use_gateloop_layers=True))
    reg = jcfg.regressor
    x = jnp.zeros((1, 8, reg.dim_out))
    init = jax.device_get(jax.jit(jvb.Regressor(reg).init)(
        jax.random.PRNGKey(3), x, jnp.zeros((1,)),
        cond_emb=jnp.zeros((1, 8, reg.dim_cond_emb)))["params"])
    tree = jax.device_get(jsynth.params.regressor)
    tree = {**tree, "transformer": {**tree["transformer"], **{
        k: v for k, v in init["transformer"].items() if k.startswith("gateloop_")}}}
    jgl = jsyn.SegmentSynthesis(config=jcfg, params=jsyn.SynthesisParams(
        jsynth.params.hubert, jsynth.params.input_mlp, tree))
    pcfg = dataclasses.replace(port.config, regressor=dataclasses.replace(
        port.config.regressor, use_gateloop_layers=True))
    pgl = tsyn.SegmentSynthesis(config=pcfg, params={
        "hubert": jax.device_get(jsynth.params.hubert),
        "input_mlp": jax.device_get(jsynth.params.input_mlp), "regressor": tree}, device="cpu")
    assert pgl.regressor.transformer.gateloop_3 is not None
    return jgl, pgl


def test_gateloop_train_step_matches_jax(gateloop_mini):
    """One step of ``loss`` + backward on the trained regressor with
    gateloop layers: JAX's scan under its op-by-op gradient, the port's scan
    under autograd."""
    jsynth, port = gateloop_mini
    batch = batch_of(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    trainable = {"input_mlp": jsynth.params.input_mlp, "regressor": jsynth.params.regressor}

    def jloss(t):
        return jsynth.loss(jsyn.SynthesisParams(jsynth.params.hubert, t["input_mlp"],
                                                t["regressor"]), jb, rng)

    with jax.disable_jit():
        want_loss, want_grads = jax.value_and_grad(jloss)(trainable)
    for m in port.trainable_modules():
        m.train()
        m.zero_grad()
    got_loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                         jax_draws(rng, batch["art"].shape))
    got_loss.backward()
    for m in port.trainable_modules():
        m.eval()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    grads = port_grad_tree(port)
    assert np.abs(flat(grads)["regressor/transformer/gateloop_0/to_qkva/kernel"]).max() > 0
    leaf, err = worst_leaf(grads, jax.device_get(want_grads))
    assert err <= GRAD_RTOL, (leaf, err)
