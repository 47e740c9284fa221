"""The port's trainer end to end on the CPU, at a tiny width.

``python -m sylber_tpu_torch.train --device cpu`` on a tiny synthetic recipe
(hidden 32, one layer, conv_dim 16): metrics, checkpoints, a resume that
repeats an uninterrupted run bit for bit, the final ``.npz`` loaded by both
packages' Segmenters with equal segments, and no start without a GPU unless
the CPU is asked for. Then the step itself: stage-1 loss falls over 20 steps
on one batch, a frozen teacher stays frozen, an EMA teacher moves, stage 2
moves the thresholder, and gradient accumulation takes one update per k
micro-batches.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sylber_tpu_torch.data.dataset import SyntheticSpeechDataset
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.train import distill

ROOT = Path(__file__).resolve().parents[1]
TINY_HUBERT = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64,
                   conv_dim=[16] * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the models here are tiny, and the test workers
    share the machine's cores (more threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _recipe(stage2=False):
    model = {"encoding_layer": 1, "hubert": dict(TINY_HUBERT), "precision": "default",
             "lr": 1e-3, "warmup_steps": 2, "total_steps": 50, "do_noise_augment": True}
    if stage2:
        model.update(segment_online=True, merge_threshold_range=[0.8, 0.9],
                     use_train_thrupdate=True,
                     thresholder_configs={"signal_mean": 6.1, "signal_var": 0.87,
                                          "noise_mean": 0.34, "noise_var": 0.34})
    return {"name": "tiny", "seed": 0, "rng_impl": "rbg", "model": model,
            "data": {"synthetic": True, "n_utts": 16, "max_len": 16000, "batch_size": 8,
                     "segment_online_data": stage2},
            "max_steps": 4}


def _start(cfg_path, out, max_steps, *extra) -> subprocess.Popen:
    # two threads each: the test runs three of them beside other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "sylber_tpu_torch.train", "--config", str(cfg_path),
         "--out-dir", str(out), "--max-steps", str(max_steps), "--log-every", "1",
         "--ckpt-every", "1", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def _finish(p: subprocess.Popen) -> subprocess.CompletedProcess:
    try:
        out, err = p.communicate(timeout=300)
    finally:
        p.kill()
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _cli(cfg_path, out, max_steps, *extra) -> subprocess.CompletedProcess:
    return _finish(_start(cfg_path, out, max_steps, *extra))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 4-step run resumed to 6 steps, and an uninterrupted 6-step run (stage 2)."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(_recipe(stage2=True)))
    running = _start(cfg, tmp / "whole", 6, "--device", "cpu")
    first = _cli(cfg, tmp / "resumed", 4, "--device", "cpu")
    second = _cli(cfg, tmp / "resumed", 6, "--device", "cpu")
    whole = _finish(running)
    for r in (first, second, whole):
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(tmp=tmp, cfg=cfg, first=first, second=second, whole=whole)


def test_cli_trains_logs_and_checkpoints(runs):
    out = runs["tmp"] / "resumed"
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    train_rows = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train_rows)
    assert all(np.isfinite(r["normthreshold"]) and r["num_segments"] > 0 for r in train_rows)
    assert "step 4: " in runs["first"].stdout
    assert sorted(int(d.name) for d in (out / "ckpts").iterdir()) == [2, 3, 4, 5, 6]  # 5 kept
    state = torch.load(out / "ckpts" / "6" / "state.pt", weights_only=True)
    assert state["step"] == 6 and state["data_seed"] == 0
    assert {"params", "ema", "optimizer", "thresholder"} <= state.keys()
    assert (out / "params_final.npz").exists()


def test_resume_repeats_the_uninterrupted_run_bit_for_bit(runs):
    assert "resumed from step 4" in runs["second"].stdout
    assert "resumed" not in runs["whole"].stdout
    a = np.load(runs["tmp"] / "resumed" / "params_final.npz")
    b = np.load(runs["tmp"] / "whole" / "params_final.npz")
    assert a.files == b.files
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    sa = torch.load(runs["tmp"] / "resumed" / "ckpts" / "6" / "state.pt", weights_only=True)
    sb = torch.load(runs["tmp"] / "whole" / "ckpts" / "6" / "state.pt", weights_only=True)
    for x, y in zip(sa["thresholder"], sb["thresholder"]):  # the last is NaN: not fixed
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_final_npz_loads_into_both_segmenters_with_equal_segments(runs):
    import jax.numpy as jnp

    from sylber_tpu.api import Segmenter as JaxSegmenter
    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu.models.hubert import HubertConfig as JaxHubertConfig
    from sylber_tpu_torch import Segmenter

    npz = runs["tmp"] / "whole" / "params_final.npz"
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_HUBERT.items()}
    wav = SyntheticSpeechDataset(n_utts=1, max_len=48000, seed=9)[0]["wav"]
    port = Segmenter(model_ckpt=str(npz), device="cpu",
                     hubert_config=HubertConfig(num_hidden_layers=1, **hub))
    norms = port(wav=wav)["frame_norms"]
    thr = float(np.median(norms))  # half the frames voiced, at any trained scale
    kw = dict(norm_threshold=thr, merge_threshold=0.9)
    got = Segmenter(model_ckpt=str(npz), device="cpu",
                    hubert_config=HubertConfig(num_hidden_layers=1, **hub), **kw)(wav=wav)
    want = JaxSegmenter(params=load_params_npz(str(npz)),
                        hubert_config=JaxHubertConfig(num_hidden_layers=1, precision="highest",
                                                      dtype=jnp.float32, **hub), **kw)(wav=wav)
    assert len(got["segments"]) >= 2
    np.testing.assert_array_equal(got["segments"], want["segments"])
    np.testing.assert_allclose(got["hidden_states"], want["hidden_states"], atol=2e-4)


def test_cli_refuses_to_start_without_a_gpu_or_the_cpu_flag(runs):
    r = _cli(runs["cfg"], runs["tmp"] / "refused", 1)
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert not (runs["tmp"] / "refused" / "metrics.jsonl").exists()


# ---- the step on a fixed batch ----------------------------------------------

def _cfg(**kw):
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_HUBERT.items()}
    model = HubertConfig(num_hidden_layers=1, precision="default", **hub)
    return distill.DistillConfig(model=model, lr=1e-3, warmup_steps=2, **kw)


def _batch(stage2=False):
    ds = SyntheticSpeechDataset(n_utts=2, max_len=16000, with_segments=not stage2, seed=1)
    b = ds.collate([ds[0], ds[1]])
    return {k: (torch.from_numpy(v) if v is not None else None) for k, v in b.items()}


def test_stage1_loss_falls_over_20_steps_and_the_frozen_teacher_stays():
    cfg = _cfg(do_noise_augment=True)
    state = distill.init_train_state(cfg, "cpu")
    teacher0 = {k: v.clone() for k, v in state.ema.items()}
    step = distill.make_train_step(cfg)
    batch = _batch()
    losses = [float(step(state, batch, 0)["loss"]) for _ in range(20)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses
    assert all(torch.equal(teacher0[k], v) for k, v in state.ema.items())


def test_ema_teacher_tracks_the_student():
    cfg = _cfg(ema_decay=0.5)
    state = distill.init_train_state(cfg, "cpu")
    step = distill.make_train_step(cfg)
    batch = _batch()
    for _ in range(4):
        step(state, batch, 0)
    student, teacher = state.student.state_dict(), state.ema
    moved = [k for k in teacher if not torch.equal(teacher[k], student[k])]
    assert moved and all(torch.isfinite(v).all() for v in teacher.values())


def test_stage2_moves_the_thresholder():
    cfg = _cfg(segment_online=True, use_train_thrupdate=True, merge_threshold_range=(0.8, 0.9))
    state = distill.init_train_state(cfg, "cpu", thresholder_kwargs={"signal_mean": 6.1})
    m = distill.make_train_step(cfg)(state, _batch(stage2=True), 0)
    assert int(m["num_segments"]) > 0 and np.isfinite(float(m["normthreshold"]))
    assert float(state.thresholder.signal_mean) != pytest.approx(6.1, abs=0)


def test_accumulation_updates_once_per_k_micro_batches():
    cfg = dataclasses.replace(_cfg(), warmup_steps=0, accumulate_grad_batches=2)
    state = distill.init_train_state(cfg, "cpu")
    step = distill.make_train_step(cfg)
    batch = _batch()
    p0 = {k: v.clone() for k, v in state.student.state_dict().items()}
    step(state, batch, 0)
    assert all(torch.equal(p0[k], v) for k, v in state.student.state_dict().items())
    step(state, batch, 0)
    assert any(not torch.equal(p0[k], v) for k, v in state.student.state_dict().items())
    assert all(not a.any() for a in state.acc_grads)
