"""A JAX training run resumed by the port's trainer, through the port's
Orbax reader (``io/checkpoint.py::TrainCheckpointManager.restore``).

- The committed fixture ``tests/fixtures/orbax/tiny_train_ckpts`` (two steps
  of the JAX ``train.py`` on ``tiny_train.yaml``, stage 2): the state the
  port restores from step 2 (parameters, EMA, AdamW's ``exp_avg`` /
  ``exp_avg_sq`` / ``step`` per parameter, the thresholder's statistics, the
  step) is bit-equal to orbax's restore of the same directory.
- JAX's ``make_train_step`` in the setting of ``test_torch_distill.py``
  (here one layer of ``mini_ckpt.npz``, no dropout, a fixed merge
  threshold), saved by the JAX package's ``TrainCheckpointManager``: stage 2
  with ``use_train_thrupdate`` after 2 steps, and stage 1 with MultiSteps
  accumulation over 2 micro-batches after 3 (so the accumulators are mid
  window). The port restores the step bit-equal to the orbax arrays, and one
  more step on the same batch gives JAX's loss, grad_norm and thresholder
  within rtol 1e-5 and its parameters within atol 1e-5 (the tolerances of
  ``test_torch_distill.py``).
- The newest step wins whichever trainer wrote it; the port's pruning and
  saving leave a JAX step alone; a JAX step without ``param_names`` raises.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from sylber_tpu.io.checkpoint import TrainCheckpointManager as JaxManager
from sylber_tpu.train import distill as jax_distill
from sylber_tpu_torch.io.checkpoint import (TrainCheckpointManager, jax_params_from_state_dict,
                                            state_dict_from_jax_params, train_state_to_jax)
from sylber_tpu_torch.train import distill as port_distill
from sylber_tpu_torch.train.loop import distill_config_from_dict
import test_torch_distill  # noqa: E402 (same-dir test module)
from test_torch_distill import (THR, _batch, _configs, _jax_batch, _port_batch,  # noqa: E402
                                mini_weights)

FIXTURE = Path(__file__).parent / "fixtures" / "orbax"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _names(state):
    return [n for n, _ in state.student.named_parameters()]


def _equal(got_sd, want_tree, what):
    want = state_dict_from_jax_params(want_tree)
    assert got_sd.keys() == want.keys(), what
    for k in want:
        assert torch.equal(got_sd[k].cpu(), want[k]), (what, k)


def _orbax_tree(step_dir):
    """orbax's restore of a JAX trainer's step, NamedTuples as dicts."""
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(str(Path(step_dir).resolve() / "default"))

    def plain(x):
        if hasattr(x, "_asdict"):
            x = x._asdict()
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x
    return plain(tree)


def _adam(tree):
    """optax's ScaleByAdamState in a restored opt_state (chain or MultiSteps)."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= tree.keys():
            return tree
        tree = list(tree.values())
    for child in tree if isinstance(tree, list) else ():
        found = _adam(child)
        if found is not None:
            return found
    return None


def check_restore(state, tree):
    adam = _adam(tree["opt_state"])
    assert adam is not None
    assert state.step == int(tree["step"])
    _equal(state.student.state_dict(), tree["params"], "params")
    _equal(state.teacher.state_dict(), tree["ema_params"], "ema")
    opt = state.optimizer.state_dict()["state"]
    moments = {m: state_dict_from_jax_params(adam[m]) for m in ("mu", "nu")}
    for i, n in enumerate(_names(state)):
        assert float(opt[i]["step"]) == float(adam["count"]) > 0
        assert torch.equal(opt[i]["exp_avg"], moments["mu"][n]), n
        assert torch.equal(opt[i]["exp_avg_sq"], moments["nu"][n]), n
    for got, key in zip(state.thresholder, ("signal_mean", "signal_var", "noise_mean",
                                            "noise_var", "fixed")):
        assert np.array_equal(got.numpy(), np.asarray(tree["thresholder"][key]), equal_nan=True)


def test_committed_jax_run_restores_bit_equal():
    recipe = yaml.safe_load((FIXTURE / "tiny_train.yaml").read_text())
    cfg = distill_config_from_dict(dict(recipe["model"]))
    state = port_distill.init_train_state(
        cfg, "cpu", thresholder_kwargs=recipe["model"]["thresholder_configs"])
    mgr = TrainCheckpointManager(str(FIXTURE / "tiny_train_ckpts"))
    assert mgr.steps() == [1, 2] and mgr.latest_step == 2
    state.load_state_dict(mgr.restore(param_names=_names(state)))
    tree = _orbax_tree(FIXTURE / "tiny_train_ckpts" / "2")
    check_restore(state, tree)
    assert float(tree["thresholder"]["signal_mean"]) != 6.1  # stage 2 moved the statistics


@pytest.mark.parametrize("k", [1, 2], ids=["adamw", "multisteps2"])
def test_one_port_step_after_a_jax_run_matches_jax(tmp_path, monkeypatch, k):
    monkeypatch.setattr(test_torch_distill, "LAYERS", 1)  # one encoder layer: a quicker jit
    weights = mini_weights()
    stage2 = k == 1  # MultiSteps in stage 1: a smaller step to compile
    jcfg, pcfg = _configs(stage2, stage2)
    jcfg, pcfg = (dataclasses.replace(c, accumulate_grad_batches=k) for c in (jcfg, pcfg))
    batch = _batch(stage2)
    jb, pb = _jax_batch(batch), _port_batch(batch)
    rng = jax.random.PRNGKey(0)
    jstate = jax_distill.init_train_state(jcfg, rng, params=weights, thresholder_kwargs=THR)
    jstep = jax.jit(jax_distill.make_train_step(jcfg))
    saved_at = 2 if k == 1 else 3  # MultiSteps: mid window, the accumulators non-zero
    for i in range(saved_at):
        jstate, _ = jstep(jstate, jb, jax.random.fold_in(rng, i))
    jmgr = JaxManager(str(tmp_path / "ckpts"))
    jmgr.save(saved_at, jax.device_get(jstate), force=True)
    jmgr.wait()
    jmgr.close()

    pstate = port_distill.init_train_state(pcfg, "cpu", params=state_dict_from_jax_params(
        weights), thresholder_kwargs=THR)
    pstate.load_state_dict(TrainCheckpointManager(str(tmp_path / "ckpts")).restore(
        param_names=_names(pstate)))
    tree = _orbax_tree(tmp_path / "ckpts" / str(saved_at))
    check_restore(pstate, tree)
    if k > 1:
        acc = state_dict_from_jax_params(tree["opt_state"]["acc_grads"])
        assert all(torch.equal(a, acc[n]) for a, n in zip(pstate.acc_grads, _names(pstate)))
        assert any(float(a.abs().max()) > 0 for a in pstate.acc_grads)

    jstate, jm = jstep(jstate, jb, jax.random.fold_in(rng, saved_at))
    pm = port_distill.make_train_step(pcfg)(pstate, pb, 0)
    assert pstate.step == saved_at + 1
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(pstate.thresholder, jstate.thresholder):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, equal_nan=True)
    got = jax_params_from_state_dict(pstate.student.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_newest_step_wins_and_jax_steps_are_left_alone(tmp_path):
    ckpts = tmp_path / "ckpts"
    shutil.copytree(FIXTURE / "tiny_train_ckpts", ckpts)
    mgr = TrainCheckpointManager(str(ckpts), max_to_keep=1)
    with pytest.raises(ValueError, match="param_names"):
        mgr.restore()
    recipe = yaml.safe_load((FIXTURE / "tiny_train.yaml").read_text())
    cfg = distill_config_from_dict(dict(recipe["model"]))
    state = port_distill.init_train_state(cfg, "cpu")
    names = _names(state)

    def tree(step):
        state.step = step
        return train_state_to_jax(state.state_dict(), names, cfg)

    with pytest.raises(FileExistsError):  # a port step may not replace a JAX one
        mgr.save(2, tree(2))
    mgr.save(3, tree(3))
    mgr.save(4, tree(4))  # prunes the port's step 3, not the JAX steps
    mgr.wait()
    assert mgr.steps() == [1, 2, 4] and mgr.restore(param_names=names)["step"] == 4
    shutil.rmtree(ckpts / "4")
    assert mgr.latest_step == 2 and mgr.restore(param_names=names)["step"] == 2
