"""The training loop (``sylber_tpu_torch/train/loop.py``) under ``mesh:`` and
``distributed:`` on 2 gloo ranks on the CPU.

The ranks start without a process group; the first ``train()`` forms it from
its ``distributed:`` block (a ``file://`` rendezvous, so test workers never
race for a port). The recipe is JAX's ``tests/multidevice/test_multiprocess.py``'s
(one layer, 32 wide, batch 8 of the synthetic corpus) with dropout 0 and
fp32 "highest". ``mesh: {dp: 2}`` runs 4 steps with a checkpoint every 2,
then is resumed to 6; ``{dp: 2, fsdp: true, fsdp_min_size: 1024}`` (the
tiny encoder's weights sharded, its convolutions and smaller leaves whole)
the same. In each:

- one ``metrics.jsonl``, written by rank 0 alone (one row a step), and
  ``resumed from step 4`` printed once;
- the losses equal the one-process ``train()``'s to rtol 2e-4 (JAX's bar in
  ``test_multiprocess.py``), and the resumed run's final parameters those
  of the uninterrupted one-process run (within 1e-5 of each leaf's largest
  magnitude, or of 1);
- ``params_final.npz`` is whole and in the JAX layout: JAX's ``Segmenter``
  loads it and segments.

A mesh larger than the world, and a ``dp`` that does not divide the batch,
raise. Under a process group a recipe's ``steps_per_dispatch`` above 1
falls back to one step a dispatch with JAX's message (JAX turns
device-resident data off in a multi-process run, which does the same).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from sylber_tpu_torch.parallel.launch import spawn

import _torch_mesh_workers as W  # noqa: E402 (same-dir helper module)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def _losses(run_dir):
    rows = [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r["prefix"] == "train"]
    return [r["step"] for r in train], [r["loss"] for r in train]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    outs = spawn(W.loop_world, 2, str(root / "worlds"), str(root), init=False)
    W._train_quiet(W.LOOP_CFG, str(root / "one"), 6, ckpt_every=0)
    return root, outs


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_rank0_alone_writes_and_losses_match_one_process(runs, name):
    root, outs = runs
    steps, losses = _losses(root / name)
    assert steps == [1, 2, 3, 4, 5, 6]              # one row a step: rank 0 alone
    _, want = _losses(root / "one")
    np.testing.assert_allclose(losses, want, rtol=2e-4)
    first, resumed = outs[0][name]
    assert "resumed from step 4" in resumed and "resumed" not in first
    assert "mesh: dp=2 mp=1" in first
    assert all(o[name][1].strip() == "" for o in outs[1:])   # rank 1 prints nothing
    assert sorted(p.name for p in (root / name / "ckpts").iterdir()) == ["2", "4", "6"]


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_resumed_mesh_run_equals_uninterrupted_one(runs, name):
    root, _ = runs
    with np.load(root / name / "params_final.npz") as got, \
            np.load(root / "one" / "params_final.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            scale = max(1.0, float(np.abs(want[k]).max()))
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, k


def test_params_final_loads_into_jax_segmenter(runs):
    from sylber_tpu.api import Segmenter
    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu.models.hubert import HubertConfig

    root, _ = runs
    hub = W.LOOP_CFG["model"]["hubert"]
    cfg = HubertConfig(num_hidden_layers=1, precision="highest",
                       **{k: tuple(v) if isinstance(v, list) else v for k, v in hub.items()})
    params = load_params_npz(str(root / "fsdp" / "params_final.npz"))
    assert params["layer_0"]["intermediate_dense"]["kernel"].shape == (32, 64)
    out = Segmenter(hubert_config=cfg, params=params)(
        wav=np.random.RandomState(0).randn(16000).astype(np.float32), in_second=False)
    assert out["hidden_states"].shape == (49, 32) and np.isfinite(out["hidden_states"]).all()


def test_the_block_forms_the_group_and_bad_meshes_raise(runs):
    _, outs = runs
    for o in outs:
        assert o["group_formed_by_block"]
        big, ragged = o["errors"]
        assert "needs 4 ranks; the world has 2" in big
        assert "does not divide the batch of 3" in ragged


def test_steps_per_dispatch_is_named_as_not_ported(runs):
    """Named as not run under a process group: on 2 gloo ranks K = 2 falls
    back to 1 with JAX's message (rank 0 prints it), and the steps are the
    dp run's, bit for bit."""
    from sylber_tpu_torch.train.loop import SPD_FALLBACK

    root, outs = runs
    assert SPD_FALLBACK in outs[0]["spd"]
    assert all(o["spd"].strip() == "" for o in outs[1:])
    steps, losses = _losses(root / "spd")
    assert steps == [1, 2] and losses == _losses(root / "dp")[1][:2]
