"""The port's resynthesis training loop (``train/synthesis_loop.py``,
``train/vq_synthesis.py``, ``python -m sylber_tpu_torch.train_synthesis``)
on the CPU.

- ``build_synthesis_corpus`` gives JAX's corpus sample for sample.
- ``precompute_features`` on 8 short utterances with the trained
  ``mini_ckpt.npz`` encoder: JAX's features within 2e-4 (and the explicit
  pitch channel within 2e-4).
- The CLI trains a shrunk mini recipe (8 utterances of 1 s, 3 steps) into a
  temporary directory: ``metrics.jsonl``, ``eval.json`` and
  ``synthesis_final.npz``, which the JAX package's ``load_params_npz`` and
  the port's ``SegmentSynthesis`` read; ``--tokens`` writes the VQ
  tokenizer, which the JAX tokenizer loads; ``--fixture-dir`` writes the
  fixtures' layout there and nowhere else.
- The batch order is JAX's; ``mesh: {dp: -1}`` is accepted, ``dp: 2`` and
  ``mp: 2`` raise; without ``--device cpu`` and without a GPU it raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_params_npz
from sylber_tpu.models.hubert import HubertModel as JaxHubert
from sylber_tpu.train import synthesis_loop as jloop
from sylber_tpu.train.vq_synthesis import TrainedVQTokenizer as JaxTokenizer
from sylber_tpu_torch.io.checkpoint import load_params_npz
from sylber_tpu_torch.synthesis import SegmentSynthesis, synthesis_config_from_dict
from sylber_tpu_torch.train import synthesis_loop as tloop

ROOT = Path(__file__).parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the test workers share the machine's cores (more
    threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_recipe(name, tmp_path, **mesh):
    cfg = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    cfg["speech_model_ckpt"] = str(FIXTURES / "mini_ckpt.npz")
    cfg["data"].update(n_utts=8, seconds=1.0)
    cfg["train"].update(batch_size=4, warmup_steps=1)
    cfg["eval"] = {"n_utts": 2}
    if mesh:
        cfg["mesh"] = mesh
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_cli(*args, device="cpu"):
    """The CLI in a subprocess on two threads (the test workers share the
    machine's cores)."""
    cmd = [sys.executable, "-m", "sylber_tpu_torch.train_synthesis", *args]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)


def test_corpus_is_jax_corpus():
    want = jloop.build_synthesis_corpus(3, 0.7, seed=5, style="rich")
    got = tloop.build_synthesis_corpus(3, 0.7, seed=5, style="rich")
    for k in ("wav", "art"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("explicit_pitch", [False, True])
def test_precompute_features_match_jax(explicit_pitch):
    mc = json.loads((FIXTURES / "mini_synth.json").read_text())["config"]["model"]
    sc = synthesis_config_from_dict(mc)
    corpus = tloop.build_synthesis_corpus(8, 1.0, seed=11)
    enc = jax_load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    nt = float(mc["norm_threshold"])
    want = jloop.precompute_features(JaxHubert(jloop.synthesis_config_from_dict(mc).hubert), enc,
                                     corpus["wav"], nt, 0.8, batch=8,
                                     explicit_pitch=explicit_pitch)
    synth = SegmentSynthesis(config=sc, params={"hubert": load_params_npz(
        str(FIXTURES / "mini_ckpt.npz")), **load_params_npz(str(FIXTURES / "mini_synth.npz"))},
        device="cpu")
    got = tloop.precompute_features(synth.hubert, corpus["wav"], nt, 0.8, batch=8,
                                    explicit_pitch=explicit_pitch)
    if not explicit_pitch:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and isinstance(g, torch.Tensor)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4)
    feats = np.asarray(want[0])
    assert ((feats ** 2).sum(-1) == 0).any() and ((feats ** 2).sum(-1) > 0).mean() > 0.5


def test_batch_order_is_jax_order():
    order = tloop.batch_order(10, 4, seed=3)
    rng = np.random.RandomState(4)
    left = np.array([], np.int64)
    for _ in range(7):
        if len(left) < 4:
            left = np.arange(10)
            rng.shuffle(left)
        want, left = left[:4], left[4:]
        np.testing.assert_array_equal(next(order), want)


def test_cli_trains_and_writes_what_both_packages_read(tmp_path):
    recipe = tiny_recipe("sylber_resynthesis_mini", tmp_path, dp=-1, mp=1)
    fx = tmp_path / "fixtures"
    done = run_cli("--config", str(recipe), "--out-dir", str(tmp_path / "run"),
                   "--max-steps", "3", "--log-every", "1", "--eval-steps", "2",
                   "--fixture-dir", str(fx))
    assert done.returncode == 0, done.stderr[-3000:]
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2, 3]
    assert all(np.isfinite(r["cfm_loss"]) for r in rows if r["prefix"] == "train")
    ev = json.loads((tmp_path / "run" / "eval.json").read_text())
    assert ev["n_eval_utts"] == 2 and ev["ode_steps"] == 2 and np.isfinite(ev["pitch_corr"])
    final = tmp_path / "run" / "synthesis_final.npz"
    jtree = jax_load_params_npz(str(final))
    assert set(jtree) == {"hubert", "input_mlp", "regressor"}
    enc = jax_load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    np.testing.assert_array_equal(jtree["hubert"]["feature_projection"]["projection"]["kernel"],
                                  enc["feature_projection"]["projection"]["kernel"])
    mc = yaml.safe_load(recipe.read_text())["model"]
    synth = SegmentSynthesis(config=synthesis_config_from_dict(mc), model_ckpt=str(final),
                             device="cpu")
    art, _ = synth.resynthesize(features=np.random.RandomState(0).randn(1, 20, 144), steps=2)
    assert art.shape == (1, 20, 14) and np.isfinite(art).all()
    assert sorted(p.name for p in fx.iterdir()) == ["mini_synth.json", "mini_synth.npz"]
    assert set(jax_load_params_npz(str(fx / "mini_synth.npz"))) == {"input_mlp", "regressor"}


def test_cli_tokens_writes_a_tokenizer_jax_loads(tmp_path):
    recipe = tiny_recipe("sylber_resynthesis_tokens_mini", tmp_path)
    done = run_cli("--tokens", "--config", str(recipe), "--out-dir", str(tmp_path / "run"),
                   "--max-steps", "2", "--log-every", "1", "--eval-steps", "2",
                   "--fixture-dir", str(tmp_path / "fx"))
    assert done.returncode == 0, done.stderr[-3000:]
    meta = json.loads((tmp_path / "fx" / "mini_vq_synth.json").read_text())
    from sylber_tpu.train.vq_synthesis import quantizer_config_from_dict

    qcfg = quantizer_config_from_dict(meta["config"]["model"]["quantizer_configs"], 144)
    tok = JaxTokenizer.load_npz(str(tmp_path / "run" / "vq_tokenizer.npz"), qcfg)
    idx = tok.get_indices(jnp.asarray(np.random.RandomState(1).randn(1, 5, 144), jnp.float32))
    assert idx.shape == (1, 5, 2)
    assert (tmp_path / "fx" / "mini_vq_tokenizer.npz").exists()
    assert np.isfinite(json.loads((tmp_path / "run" / "eval.json").read_text())["loud_corr"])


@pytest.mark.parametrize("mesh,error", [({"dp": 2}, ValueError),
                                        ({"dp": -1, "mp": 2}, ValueError)])
def test_a_mesh_beyond_one_device_raises(tmp_path, mesh, error):
    """Without a process group a mesh of two ranks has no second rank (the
    data-parallel runs are in ``test_torch_mesh_trainers.py``); mp > 1 is
    refused either way."""
    cfg = yaml.safe_load(tiny_recipe("sylber_resynthesis_mini", tmp_path).read_text())
    cfg["mesh"] = mesh
    with pytest.raises(error, match="alone" if mesh["dp"] == 2 else "mp"):
        tloop.train_synthesis(cfg, out_dir=str(tmp_path / "run"), max_steps=1, device="cpu")
    tloop.check_mesh({"mesh": {"dp": -1, "mp": 1}})
    tloop.check_mesh({"mesh": {"dp": 1}})


def test_cli_refuses_to_start_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    done = run_cli("--config", str(tiny_recipe("sylber_resynthesis_mini", tmp_path)),
                   "--out-dir", str(tmp_path / "run"), "--max-steps", "1", device=None)
    assert done.returncode != 0 and "cpu" in done.stderr
    assert not (tmp_path / "run").exists()
