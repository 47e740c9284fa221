"""Three updates of the port's resynthesis train step against
``sylber_tpu/synthesis.py::make_synthesis_train_step`` (run op by op, see
``test_torch_synthesis_train.py``) on the CPU, fp32, from the trained
``mini_synth.npz`` with JAX's draws: the loss within rtol 1e-5, the
gradient norm within 1e-4, the parameters after three updates within 1e-6
(at the mini recipe's peak rate, 4e-4, with no warm-up, so that they move);
the frozen encoder has no gradient and no optimizer slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sylber_tpu import synthesis as jsyn
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.io.checkpoint import tree_from_state_dict
from test_torch_synthesis_train import (LOSS_RTOL, PARAM_ATOL, _few_threads,  # noqa: E402,F401
                                        batch_of, flat, jax_draws, pair)


@pytest.fixture(scope="module")
def mini():
    return pair("mini_synth")


def test_three_train_steps_match_jax(mini):
    jsynth, port = mini
    kw = dict(lr=4e-4, warmup_steps=0, total_steps=100, min_factor=0.05)
    jopt = jsyn.make_synthesis_optimizer(**kw)
    update = jax.jit(jopt.update)
    trainable = {"input_mlp": jsynth.params.input_mlp, "regressor": jsynth.params.regressor}
    opt_state = jopt.init(trainable)
    popt = tsyn.make_synthesis_optimizer(**kw)
    pstate = tsyn.init_synthesis_train_state(port, popt)
    pstep = tsyn.make_synthesis_train_step(port, popt)
    assert sum(p.numel() for p in pstate.params) == sum(
        v.size for v in flat({"i": jsynth.params.input_mlp, "r": jsynth.params.regressor}).values())
    assert not any(p.requires_grad for p in port.hubert.parameters())
    rng = jax.random.PRNGKey(0)
    for i in range(3):
        batch = batch_of(seed=10 + i)
        krng = jax.random.fold_in(rng, i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jloss(t, jb=jb, krng=krng):
            return jsynth.loss(jsyn.SynthesisParams(jsynth.params.hubert, t["input_mlp"],
                                                    t["regressor"]), jb, krng)

        # the body of make_synthesis_train_step, its gradient taken op by op
        with jax.disable_jit():
            loss, grads = jax.value_and_grad(jloss)(trainable)
        updates, opt_state = update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        jm = {"cfm_loss": loss, "grad_norm": optax.global_norm(grads)}
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                   draws=jax_draws(krng, batch["art"].shape))
        np.testing.assert_allclose(float(pm["cfm_loss"]), float(jm["cfm_loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert pstate.step == 3 and len(pstate.optimizer.state) == len(pstate.params)
    want = jax.device_get(trainable)
    got = {"input_mlp": tree_from_state_dict(port.input_mlp.state_dict()),
           "regressor": tree_from_state_dict(port.regressor.state_dict())}
    g, w = flat(got), flat(want)
    moved = max(float(np.abs(w[k] - v).max()) for k, v in flat(
        {"input_mlp": jsynth.params.input_mlp, "regressor": jsynth.params.regressor}).items())
    assert moved > 1e-4  # the updates are not vacuous
    worst = max(float(np.abs(g[k] - w[k]).max()) for k in w)
    assert worst <= PARAM_ATOL, worst
    assert not port.regressor.training and not port.input_mlp.training
