"""``steps_per_dispatch``: K distillation steps a dispatch, on the CPU.

The port's counterpart of ``tests/smoke/test_steps_per_dispatch.py``, case
for case, on the same tiny config, with ``device="cpu"``: there the K-step
dispatch (``sylber_tpu_torch/train/dispatch.py``) runs the steps eagerly on
the static buffers that a CUDA graph replays on the card (the index and row
buffers read at a device cursor, the merge threshold and the learning rate
from device memory, the generators of ``StepRandom`` reseeded before each
step). Its contract is the one-step loop's math: the same batches from one
index stream, the same per-step draws, the same metric rows. The steps run
the same code either way, so the losses, grad norms, metric rows and the
parameters are held bit for bit (tolerance 0); the JAX test's own bounds
(rtol 1e-5, atol 1e-6) are looser because XLA compiles the scan apart.

The step's math against JAX's step is held by ``test_torch_distill.py``,
``test_torch_distill_stage2*.py`` and ``test_torch_distill_bf16.py``; this
file does not run JAX's loop again. On the card ``chip_smoke.py
--only-dispatch`` holds the captured graph's steps to one-step steps.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from sylber_tpu_torch.train.loop import SPD_FALLBACK, train

TINY = {"hidden_size": 32, "num_attention_heads": 4, "intermediate_size": 64,
        "conv_dim": [16] * 7, "num_conv_pos_embeddings": 16,
        "num_conv_pos_embedding_groups": 4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the models are tiny, and test workers share cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg(spd, stage2=False, accumulate=1, resident=True):
    """``tests/smoke/test_steps_per_dispatch.py::_cfg``; ``stage2``: online
    segmentation, the thresholder, a merge-threshold range that is not
    empty, noise mixing, dropout (HuBERT's 0.1) and remat."""
    model = {"encoding_layer": 1, "hubert": dict(TINY), "precision": "default",
             "lr": 1e-3, "warmup_steps": 2, "total_steps": 50}
    data = {"synthetic": True, "n_utts": 16, "max_len": 16000, "batch_size": 8,
            "device_resident": resident}
    if stage2:
        model.update(segment_online=True, merge_threshold_range=[0.6, 0.9],
                     use_train_thrupdate=True, do_noise_augment=True,
                     noise_mixer_configs={"augment_prob": 0.5},
                     thresholder_configs={"signal_mean": 1.0, "signal_var": 0.5,
                                          "noise_mean": 0.1, "noise_var": 0.1})
        model["hubert"]["remat"] = True
        data["segment_online_data"] = True
    return {"name": "spd", "seed": 0, "model": model, "data": data,
            "steps_per_dispatch": spd, "accumulate_grad_batches": accumulate}


def _run(cfg, out_dir, max_steps, **kw):
    """``train()`` on the CPU: the state and the printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train(cfg, out_dir=str(out_dir), max_steps=max_steps, log_every=1,
                      device="cpu", **kw)
    return state, buf.getvalue()


def _rows(out_dir):
    """The train rows of ``metrics.jsonl`` by step, without the host's timing."""
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    return {r["step"]: {k: v for k, v in r.items()
                        if k not in ("time", "steps_per_sec", "mfu")}
            for r in rows if r["prefix"] == "train"}


def _assert_same_run(a_dir, b_dir, a, b, steps):
    ra, rb = _rows(a_dir), _rows(b_dir)
    assert set(ra) == set(rb) == set(range(1, steps + 1))
    assert ra == rb  # every metric of every step, bit for bit
    pa, pb = a.student.state_dict(), b.student.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert a.step == b.step == steps


def test_multi_step_dispatch_matches_single_step(tmp_path):
    """K 3 against K 1 over 6 steps: the same losses and parameters."""
    s1, _ = _run(_cfg(1), tmp_path / "s1", 6, ckpt_every=10 ** 9)
    s3, _ = _run(_cfg(3), tmp_path / "s3", 6, ckpt_every=10 ** 9)
    _assert_same_run(tmp_path / "s1", tmp_path / "s3", s1, s3, 6)


def test_multi_step_remainder_and_resume(tmp_path):
    """max_steps 7 with K 3: two dispatches and a one-step remainder; then
    a resume from step 6 (not K-aligned) to 10. Checkpoints fire on interval
    crossings: with interval 2 the dispatch boundaries 3, 6, 7 save 3 and 6,
    and after the resume 9 and 10. The resumed steps equal an uninterrupted
    one-step run's."""
    d = tmp_path / "s7"
    s, _ = _run(_cfg(3), d, 7, ckpt_every=2)
    assert s.step == 7
    saved = sorted(int(x) for x in os.listdir(d / "ckpts") if x.isdigit())
    assert saved == [3, 6], saved
    s2, out = _run(_cfg(3), d, 10, ckpt_every=2)
    assert "resumed from step 6" in out and s2.step == 10
    saved2 = sorted(int(x) for x in os.listdir(d / "ckpts") if x.isdigit())
    assert saved2 == [3, 6, 9, 10], saved2
    rows = _rows(d)
    assert set(rows) == set(range(1, 11))
    one, _ = _run(_cfg(1), tmp_path / "one", 10, ckpt_every=10 ** 9)
    assert rows == _rows(tmp_path / "one")
    pa, pb = s2.student.state_dict(), one.student.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("case", ["stage2", "accumulate"])
def test_stage2_and_accumulation_dispatch_match_single_step(tmp_path, case):
    """K 4 against K 1 over 8 steps. ``stage2``: the merge threshold is read
    from the device row, the thresholder is updated in place, the span of
    draws (noise mixing, dropout, the remat layer's second generator) come
    from the reseeded generators. ``accumulate``: ``accumulate_grad_batches``
    2, each position of the window its own step (its own graph on the card)."""
    kw = {"stage2": True} if case == "stage2" else {"accumulate": 2}
    s1, _ = _run(_cfg(1, **kw), tmp_path / "k1", 8, ckpt_every=10 ** 9)
    s4, _ = _run(_cfg(4, **kw), tmp_path / "k4", 8, ckpt_every=10 ** 9)
    _assert_same_run(tmp_path / "k1", tmp_path / "k4", s1, s4, 8)
    for a, b in zip(s1.thresholder, s4.thresholder):  # `fixed` is NaN: estimated
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    if case == "stage2":
        rows = _rows(tmp_path / "k4")
        assert len({r["normthreshold"] for r in rows.values()}) > 1  # it moved
    else:
        assert all(torch.equal(a, b) for a, b in zip(s1.acc_grads, s4.acc_grads))


@pytest.mark.parametrize("why", ["profile_steps", "streamed corpus"])
def test_fallback_to_one_step_prints_jax_message(tmp_path, why):
    """JAX's two fall-backs: with ``profile_steps`` set, or without
    device-resident data, the loop prints JAX's message and runs K = 1."""
    if why == "profile_steps":
        cfg, kw = _cfg(4), {"profile_steps": (0, 0)}
    else:
        cfg, kw = _cfg(4, resident=False), {}
    s, out = _run(cfg, tmp_path / "run", 3, ckpt_every=10 ** 9, **kw)
    assert SPD_FALLBACK in out and s.step == 3
    assert set(_rows(tmp_path / "run")) == {1, 2, 3}
    one, _ = _run(dict(cfg, steps_per_dispatch=1), tmp_path / "one", 3, ckpt_every=10 ** 9,
                  **kw)
    assert _rows(tmp_path / "run") == _rows(tmp_path / "one")
    assert np.isfinite([r["loss"] for r in _rows(tmp_path / "run").values()]).all()
