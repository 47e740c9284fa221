"""Data parallelism of the resynthesis trainers on 2 gloo ranks on the CPU,
the counterparts of ``tests/multidevice/test_trainer_meshes.py``:

- ``train_synthesis`` (CFM) with ``mesh: {dp: 2}``: JAX's tiny recipe there
  (a random 2-layer 32-wide encoder, a 1-deep regressor, 16 utterances of
  1 s, batch 8, dropout 0: each rank seeds its own masks), 4 steps: the
  loss trajectory within rtol 2e-4 of one process (JAX's bar) and the final
  parameters within atol 2e-5 + rtol 2e-4; rank 0 alone writes;
- the joint-VQ step (``train/vq_synthesis.py``) from the mini fixtures, 3
  steps on a global batch of 4 x 24 frames with blank frames, every EMA
  count set just above the dead threshold so that the codes the batch
  misses die and are reseeded from the global batch's points: the losses
  rtol 2e-4, the codebooks, EMA counts and sums within 1e-5 (the counts
  exactly), and codes were reseeded;
- one vocoder GAN step (B8 x 16 frames): ``d_loss``, ``g_loss`` and
  ``mel_l1`` rtol 2e-4 and the generator's parameters at JAX's atol 2e-5 /
  rtol 2e-4.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sylber_tpu_torch.parallel.launch import spawn
from sylber_tpu_torch.train.synthesis_loop import train_synthesis

import _torch_mesh_workers as W  # noqa: E402 (same-dir helper module)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


def _cfm_cfg(mesh=None):
    """``tests/multidevice/test_trainer_meshes.py``'s tiny recipe."""
    cfg = {
        "name": "mesh_test", "seed": 0,
        "model": {
            "encoding_layer": 2,
            "hubert": {"hidden_size": 32, "num_attention_heads": 4, "intermediate_size": 64,
                       "conv_dim": [16] * 7, "num_conv_pos_embeddings": 16,
                       "num_conv_pos_embedding_groups": 4},
            "norm_threshold": 0.5, "merge_threshold_range": [0.8, 0.8],
            "input_configs": {"output_dim": 16, "hidden_dims": [16], "dropout": 0.0},
            "regressor_configs": {"depth": 1, "dim": 32, "heads": 2, "dim_head": 16,
                                  "dim_in_proj": 16, "dim_cond_emb": 16, "sigma": 0.0},
        },
        "data": {"synthetic": True, "n_utts": 16, "seconds": 1.0},
        "train": {"batch_size": 8, "lr": 1e-3, "warmup_steps": 1, "max_steps": 4,
                  "min_factor": 1.0},
        "eval": {"n_utts": 2},
    }
    if mesh:
        cfg["mesh"] = mesh
    return cfg


def _cfm_losses(run_dir):
    rows = [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["cfm_loss"]) for r in rows if "cfm_loss" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    outs = spawn(W.trainer_world, 2, str(root / "worlds"), str(root), str(FIXTURES),
                 _cfm_cfg({"dp": 2}))
    torch.set_num_threads(2)
    train_synthesis(_cfm_cfg(), out_dir=str(root / "cfm_one"), max_steps=4, log_every=1,
                    eval_steps=2, device="cpu")
    return root, outs


def test_cfm_trajectory_at_dp2_matches_one_process(runs):
    root, _ = runs
    got, want = _cfm_losses(root / "cfm"), _cfm_losses(root / "cfm_one")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=2e-4)
    with np.load(root / "cfm" / "synthesis_final.npz") as a, \
            np.load(root / "cfm_one" / "synthesis_final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], atol=2e-5, rtol=2e-4, err_msg=k)
    assert (root / "cfm" / "eval.json").exists()


def test_vq_codebooks_at_dp2_match_one_process(runs):
    _, outs = runs
    got, want = outs[0]["vq"], W.vq_steps(None, str(FIXTURES))
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "cfm_loss", "commit_loss", "pitch_loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, err_msg=k)
    for k, v in want.items():
        if k == "metrics":
            continue
        if k.endswith("cluster_sizes"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    assert np.allclose(outs[1]["vq"]["art_vq_codebooks"], got["art_vq_codebooks"])
    # codes the batch missed died and were reseeded with twice the threshold
    assert (np.isclose(want["art_vq_cluster_sizes"], 2.0)).sum() > 0


def test_vocoder_step_at_dp2_matches_one_process(runs):
    _, outs = runs
    got, want = outs[0]["vocoder"], W.vocoder_step(None)
    for k in ("d_loss", "g_loss", "mel_l1"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-4, err_msg=k)
    for k, v in want["gen"].items():
        np.testing.assert_allclose(got["gen"][k], v, atol=2e-5, rtol=2e-4, err_msg=k)
