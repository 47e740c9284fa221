"""The port's trainer writes the JAX trainer's Orbax steps, asynchronously,
and the JAX package resumes them (``io/checkpoint.py::TrainCheckpointManager``,
``train_state_to_jax``, ``train/loop.py``).

- The port's ``train()`` on ``tests/fixtures/orbax/tiny_train.yaml`` runs 2
  steps with ``ckpt_every`` 1 at stage 2, and at stage 1 with MultiSteps
  over 2 micro-batches (step 1 before AdamW's first update, step 2 after
  it). Each step directory holds ``default/``, ``_CHECKPOINT_METADATA`` and
  ``port.json``; ``params_final/`` holds the ``params_final.npz`` arrays.
- The JAX package's ``TrainCheckpointManager.restore``, given the JAX
  trainer's own initial state as ``state_like`` (its shapes and dtypes,
  ``jax.eval_shape`` of ``init_train_state``), restores both steps: every
  leaf of step 2 equals ``train_state_to_jax`` of the port's live state,
  bit for bit, and step 1 the port's own reading of it.
- The JAX trainer (``sylber_tpu.train.loop.train``) resumes the port's
  stage-2 run for one step with a finite loss.
- The port resumes its own Orbax step 1 with the same bits as from a
  ``state.pt`` of the same state, and both equal the uninterrupted run.
- Tensors changed in place between ``save`` and ``wait()`` leave the
  written step as it was at ``save``; a write into a directory that cannot
  be written (a file stands in its place) raises at ``wait()`` and leaves
  no step and no other format behind.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_threads import _few_threads  # noqa: F401
from sylber_tpu.io.checkpoint import TrainCheckpointManager as JaxManager
from sylber_tpu.train import distill as jax_distill
from sylber_tpu.train.loop import distill_config_from_dict as jax_config_from_dict
from sylber_tpu.train.loop import train as jax_train
from sylber_tpu_torch.io.checkpoint import (TrainCheckpointManager, load_params_npz,
                                            train_state_to_jax)
from sylber_tpu_torch.io.orbax import load_params, read_tree
from sylber_tpu_torch.train import distill as port_distill
from sylber_tpu_torch.train.loop import distill_config_from_dict, train

FIXTURE = Path(__file__).parent / "fixtures" / "orbax"
STAGES = ["stage2", "stage1-multisteps"]



def _recipe(stage):
    recipe = yaml.safe_load((FIXTURE / "tiny_train.yaml").read_text())
    if stage == "stage1-multisteps":
        recipe["model"].update(segment_online=False, use_train_thrupdate=False)
        recipe["data"]["segment_online_data"] = False
        recipe["accumulate_grad_batches"] = 2
    return recipe


def _config(recipe):
    return distill_config_from_dict(dict(recipe["model"], accumulate_grad_batches=recipe.get(
        "accumulate_grad_batches", 1)))


def _names(state):
    return [n for n, _ in state.student.named_parameters()]


def _train(recipe, out, steps, ckpt_every=1):
    return train(recipe, out_dir=str(out), max_steps=steps, log_every=1, ckpt_every=ckpt_every,
                 device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for stage in STAGES:
        d = tmp_path_factory.mktemp(stage)
        recipe = _recipe(stage)
        out[stage] = dict(recipe=recipe, out=d, state=_train(recipe, d, 2))
    return out


def _numpy(tree):
    """A JAX-layout tree with tensors as numpy arrays, sequences as lists."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _plain(tree):
    """orbax's restore with NamedTuples as dicts, an EmptyState as None."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict() or None
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def assert_same(got, want, path="state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got.keys(),
                                                                     want.keys())
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (path, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("stage", STAGES)
def test_port_run_writes_orbax_steps(runs, stage):
    run = runs[stage]
    ckpts = run["out"] / "ckpts"
    assert sorted(d.name for d in ckpts.iterdir()) == ["1", "2"]
    for step in (1, 2):
        d = ckpts / str(step)
        assert sorted(p.name for p in d.iterdir()) == ["_CHECKPOINT_METADATA", "default",
                                                       "port.json"]
        assert json.loads((d / "port.json").read_text()) == {"data_seed": 0, "step": step}
        meta = json.loads((d / "_CHECKPOINT_METADATA").read_text())
        assert meta["item_handlers"]["default"].endswith("StandardCheckpointHandler")
    state = run["state"]
    want = _numpy(train_state_to_jax(state.state_dict(), _names(state), _config(run["recipe"])))
    assert_same(read_tree(ckpts / "2" / "default"), want)
    adam = want["opt_state"][1][0] if stage == "stage2" else \
        want["opt_state"]["inner_opt_state"][1][0]
    assert int(adam["count"]) == 2 if stage == "stage2" else int(adam["count"]) == 1
    npz = load_params_npz(str(run["out"] / "params_final.npz"))
    assert_same(load_params(run["out"] / "params_final"), npz)
    saves = [json.loads(ln) for ln in open(run["out"] / "checkpoints.jsonl")]
    assert [r["step"] for r in saves] == [1, 2]
    assert all(r["bytes"] > 0 and r["write_s"] > 0 and r["disk_bytes"] >= r["bytes"]
               for r in saves)


@pytest.mark.parametrize("stage", STAGES)
def test_jax_manager_restores_the_ports_steps(runs, stage):
    run = runs[stage]
    recipe = run["recipe"]
    jcfg = jax_config_from_dict(dict(recipe["model"], accumulate_grad_batches=recipe.get(
        "accumulate_grad_batches", 1)))
    # the JAX trainer's own initial state as shapes and dtypes (running its
    # random init costs seconds of op-by-op compiles)
    like = jax.eval_shape(lambda: jax_distill.init_train_state(
        jcfg, jax.random.PRNGKey(0), thresholder_kwargs=recipe["model"].get(
            "thresholder_configs")))
    device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=device), like)
    mgr = JaxManager(str(run["out"] / "ckpts"))
    try:
        assert mgr.latest_step == 2
        latest = _plain(mgr.restore(like))
        first = _plain(mgr.restore(like, step=1))
    finally:
        mgr.close()
    state = run["state"]
    names = _names(state)
    assert_same(latest, _numpy(train_state_to_jax(state.state_dict(), names, _config(recipe))))
    one = read_tree(run["out"] / "ckpts" / "1" / "default")
    if stage == "stage1-multisteps":  # before AdamW's first update: zero moments, count 0
        inner = first["opt_state"]["inner_opt_state"][1]
        assert int(inner[0]["count"]) == 0 and int(first["opt_state"]["mini_step"]) == 1
        assert not np.any(inner[0]["mu"]["encoder_layer_norm"]["bias"])
    for opt in (first["opt_state"], one["opt_state"]):  # the EmptyStates, read as None
        chain = opt if stage == "stage2" else opt["inner_opt_state"]
        assert chain[0] is None and chain[1][1] is None
    assert_same(first, one)


def test_jax_trainer_resumes_the_ports_run(runs, tmp_path, capsys):
    run = runs["stage2"]
    shutil.copytree(run["out"] / "ckpts", tmp_path / "ckpts")
    # init_params: the restore replaces them; given, the JAX loop skips a random init
    jax_train(dict(run["recipe"], mesh={"dp": 1}), out_dir=str(tmp_path), max_steps=3,
              log_every=1, ckpt_every=0,
              init_params=read_tree(tmp_path / "ckpts" / "2" / "default")["params"])
    assert "resumed from step 2" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [3] and np.isfinite(rows[0]["loss"])


def _flat(state):
    """Every tensor of a port train state, by name."""
    d = state.state_dict()
    out = {f"params/{k}": v for k, v in d["params"].items()}
    out.update({f"ema/{k}": v for k, v in d["ema"].items()})
    for i, st in d["optimizer"]["state"].items():
        out.update({f"adamw/{i}/{k}": v for k, v in st.items()})
    out.update({f"thresholder/{i}": v for i, v in enumerate(d["thresholder"])})
    out.update({f"acc/{i}": v for i, v in enumerate(d["acc_grads"] or ())})
    return d["step"], out


def _bit_equal(a, b):
    (sa, ta), (sb, tb) = _flat(a), _flat(b)
    assert sa == sb and ta.keys() == tb.keys()
    bad = [k for k in ta if ta[k].numpy().tobytes() != tb[k].numpy().tobytes()]
    assert not bad, bad


@pytest.mark.parametrize("stage", STAGES)
def test_port_resumes_its_orbax_step_as_from_state_pt(runs, stage, tmp_path):
    run = runs[stage]
    recipe = run["recipe"]
    shutil.copytree(run["out"] / "ckpts" / "1", tmp_path / "orbax" / "ckpts" / "1")
    first = _train(recipe, tmp_path / "pt", 1, ckpt_every=0)
    (tmp_path / "pt" / "ckpts" / "1").mkdir(parents=True)
    torch.save(dict(first.state_dict(), data_seed=0), tmp_path / "pt" / "ckpts" / "1" / "state.pt")
    from_orbax = _train(recipe, tmp_path / "orbax", 2, ckpt_every=0)
    from_pt = _train(recipe, tmp_path / "pt", 2, ckpt_every=0)
    _bit_equal(from_orbax, from_pt)
    _bit_equal(from_orbax, run["state"])


def test_save_copies_the_state_and_a_failed_write_raises(tmp_path):
    recipe = _recipe("stage2")
    cfg = _config(recipe)
    state = port_distill.init_train_state(cfg, "cpu",
                                          thresholder_kwargs=recipe["model"]["thresholder_configs"])
    names = _names(state)
    mgr = TrainCheckpointManager(str(tmp_path / "ckpts"), max_to_keep=1)
    tree = train_state_to_jax(state.state_dict(), names, cfg)
    want = _numpy(tree)
    mgr.save(1, tree, marker={"data_seed": 5})
    with torch.no_grad():  # the in-place updates of a next step
        for p in list(state.student.parameters()) + list(state.teacher.parameters()):
            p.add_(1.0)
        for t in state.thresholder:
            t.add_(1.0)
    mgr.wait()
    assert_same(read_tree(tmp_path / "ckpts" / "1" / "default"), want)
    assert mgr.restore(param_names=names)["data_seed"] == 5
    mgr.save(2, tree)  # prunes step 1
    mgr.close()
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == ["2"]

    bad = tmp_path / "unwritable"
    mgr = TrainCheckpointManager(str(bad))
    bad.rmdir()
    bad.write_text("a file where the checkpoint directory was")
    mgr.save(3, tree)
    with pytest.raises(RuntimeError, match="writing a checkpoint") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.close()  # the error was raised once
    assert bad.is_file() and sorted(p.name for p in tmp_path.iterdir()) == ["ckpts",
                                                                            "unwritable"]
