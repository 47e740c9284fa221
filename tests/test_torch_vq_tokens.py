"""The port's trainable-quantizer inference (``sylber_tpu_torch/flow/quantizer.py``,
``sylber_tpu_torch/vq_tokenizer.py``) against the JAX package on the CPU.

- the grouped residual VQ (``vq_encode`` / ``vq_decode`` / ``vq_forward``):
  indices equal to JAX's (no distance is within 1e-6 of a tie on these
  seeded inputs), decoded features within 1e-6, straight-through
  gradients of 1;
- a reference torch ``Quantizer`` checkpoint converted by both packages
  (``quantizer_state_from_torch``, the case of
  ``tests/unit/test_torch_convert_synthesis.py``) gives the same state and
  the same ``quantizer_forward`` / ``quantizer_decode``; ``load_quantizer``
  reads such a file;
- ``TrainedVQTokenizer`` on ``mini_vq_tokenizer.npz``: JAX's tokens and
  decoded features (1e-6), a save / load round trip bit for bit, and the
  token path of ``mini_vq_synth.npz``: JAX's segments and art within 1e-4
  of the largest.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.flow import quantizer as jq
from sylber_tpu.io.torch_convert import quantizer_state_from_torch as jax_state_from_torch
from sylber_tpu.train import vq_synthesis as jvq
from sylber_tpu_torch import vq_tokenizer as tvq
from sylber_tpu_torch.flow import quantizer as tq
from sylber_tpu_torch.io.torch_convert import quantizer_state_from_torch
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "mini_vq_synth.json").read_text())


def _qcfg(mod):
    qd = META["quantizer_config"]
    return mod.QuantizerConfig(
        input_dim=qd["input_dim"], output_dim=qd["output_dim"],
        hidden_dims=tuple(qd["hidden_dims"]), pitch_emb_dim=qd["pitch_emb_dim"],
        art_vq=mod.GroupedResidualVQConfig(**qd["art_vq"]),
        pitch_vq=mod.GroupedResidualVQConfig(**qd["pitch_vq"]))


def test_grouped_residual_vq_matches_jax():
    jcfg = jq.GroupedResidualVQConfig(dim=16, groups=2, num_quantizers=3, codebook_size=64)
    tcfg = tq.GroupedResidualVQConfig(dim=16, groups=2, num_quantizers=3, codebook_size=64)
    st = jax.device_get(jq.vq_init(jax.random.PRNGKey(0), jcfg))
    tst = tq.VQState(*(torch.from_numpy(np.array(a)) for a in st))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (5, 9, 16))) * np.float32(0.02)
    want = np.asarray(jq.vq_encode(st, jcfg, jnp.asarray(x)))
    got = tq.vq_encode(tst, tcfg, torch.from_numpy(x))
    assert got.shape == (5, 9, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tq.vq_decode(tst, tcfg, got).numpy(),
                               np.asarray(jq.vq_decode(st, jcfg, jnp.asarray(want))), atol=1e-6)
    xt = torch.from_numpy(x).requires_grad_()
    q, idx, commit = tq.vq_forward(tst, tcfg, xt)
    jqv, _, jcommit = jq.vq_forward(st, jcfg, jnp.asarray(x))
    assert torch.equal(idx, got)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jqv), atol=1e-6)
    np.testing.assert_allclose(float(commit.detach()), float(jcommit), rtol=1e-5)
    q.sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


def _fake_quantizer_sd(rng):
    """Reference trainable-Quantizer names (vector-quantize-pytorch layout)."""
    sd = {"encoder.mlp.0.weight": rng.randn(20, 24), "encoder.mlp.0.bias": rng.randn(20),
          "encoder.mlp.1.0.weight": rng.randn(20, 20), "encoder.mlp.1.0.bias": rng.randn(20),
          "encoder.mlp.1.3.weight": rng.randn(20, 20), "encoder.mlp.1.3.bias": rng.randn(20),
          "encoder.mlp.2.weight": rng.randn(16, 20), "encoder.mlp.2.bias": rng.randn(16)}
    for g in range(2):
        for q in range(2):
            sd[f"art_vq.rvqs.{g}.layers.{q}._codebook.embed"] = rng.randn(1, 32, 6)
    sd["pitch_vq.rvqs.0.layers.0._codebook.embed"] = rng.randn(1, 16, 4)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _small_cfg(mod):
    return mod.QuantizerConfig(
        input_dim=24, output_dim=16, hidden_dims=(20,), pitch_emb_dim=4,
        art_vq=mod.GroupedResidualVQConfig(dim=12, groups=2, num_quantizers=2, codebook_size=32),
        pitch_vq=mod.GroupedResidualVQConfig(dim=4, codebook_size=16))


def test_quantizer_checkpoint_conversion_and_forward_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    sd = _fake_quantizer_sd(rng)
    jstate = jax_state_from_torch(sd, _small_cfg(jq))
    tstate = quantizer_state_from_torch({k: torch.from_numpy(v) for k, v in sd.items()},
                                        _small_cfg(tq))
    assert tstate.art_vq.codebooks.shape == (2, 2, 32, 6)
    assert tstate.pitch_vq.codebooks.shape == (1, 1, 16, 4)
    for a, b in zip(tstate.encoder, jstate.encoder):
        assert np.array_equal(a["kernel"].numpy(), np.asarray(b["kernel"]))
    x = rng.randn(2, 5, 24).astype(np.float32)
    x[0, 2] = 0.0  # a blank token stays zero
    got = tq.quantizer_forward(tstate, _small_cfg(tq), torch.from_numpy(x))
    want = jq.quantizer_forward(jstate, _small_cfg(jq), jnp.asarray(x))
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    np.testing.assert_allclose(got["quantize"].numpy(), np.asarray(want["quantize"]), atol=1e-6)
    assert float(got["non_quantized"][0, 2].abs().sum()) == 0.0
    dec = tq.quantizer_decode(tstate, _small_cfg(tq), got["indices"])
    np.testing.assert_allclose(dec.numpy(), np.asarray(jq.quantizer_decode(
        jstate, _small_cfg(jq), want["indices"])), atol=1e-6)
    config = {"encoder_configs": {"input_dim": 24, "output_dim": 16, "hidden_dims": [20]},
              "pitch_emb_dim": 4,
              "art_vq_configs": {"dim": 12, "groups": 2, "num_quantizers": 2, "codebook_size": 32},
              "pitch_vq_configs": {"dim": 4, "codebook_size": 16}}
    torch.save({"config": config, "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "quantizer.ckpt")
    state, cfg = tq.load_quantizer(str(tmp_path / "quantizer.ckpt"), device="cpu")
    assert cfg == _small_cfg(tq) and torch.equal(state.art_vq.codebooks, tstate.art_vq.codebooks)


def test_config_from_dict_equals_jax():
    d = META["config"]["model"]["quantizer_configs"]
    got, want = tvq.quantizer_config_from_dict(d, 144), jvq.quantizer_config_from_dict(d, 144)
    assert dataclass_dict(got) == dataclass_dict(want) and got == _qcfg(tq)


def dataclass_dict(c):
    import dataclasses

    return json.loads(json.dumps(dataclasses.asdict(c), default=str))


@pytest.fixture(scope="module")
def tokenizers():
    path = str(FIXTURES / "mini_vq_tokenizer.npz")
    return (jvq.TrainedVQTokenizer.load_npz(path, _qcfg(jq)),
            tvq.TrainedVQTokenizer.load_npz(path, _qcfg(tq), device="cpu"))


def test_trained_tokenizer_matches_jax_and_round_trips(tokenizers, tmp_path):
    jtok, ttok = tokenizers
    feats = np.random.RandomState(3).randn(3, 7, 144).astype(np.float32)
    feats[1, 2] = 0.0
    want = np.asarray(jtok.get_indices(jnp.asarray(feats)))
    got = ttok.get_indices(feats)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(ttok.decode(got).numpy(),
                               np.asarray(jtok.decode(jnp.asarray(want))), atol=1e-6)
    ttok.save_npz(str(tmp_path / "tok.npz"))
    again = tvq.TrainedVQTokenizer.load_npz(str(tmp_path / "tok.npz"), _qcfg(tq), device="cpu")
    with np.load(FIXTURES / "mini_vq_tokenizer.npz") as a, np.load(tmp_path / "tok.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    assert torch.equal(again.get_indices(feats), got)


def test_token_path_resynthesis_matches_jax(tokenizers):
    from sylber_tpu import synthesis as jsyn
    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu.train.synthesis_loop import build_synthesis_corpus
    from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config
    from sylber_tpu_torch import synthesis as tsyn

    jtok, ttok = tokenizers
    mc = META["config"]["model"]
    trained = load_params_npz(str(FIXTURES / "mini_vq_synth.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jitted = type("JittedTokenizer", (), {"get_indices": staticmethod(jax.jit(jtok.get_indices)),
                                          "decode": staticmethod(jax.jit(jtok.decode))})
    jax_synth = jsyn.SegmentSynthesis(config=jax_config(mc), quantizer=jitted,
                                      params=jsyn.SynthesisParams(enc, trained["input_mlp"],
                                                                  trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=tsyn.synthesis_config_from_dict(mc),
                                 params={"hubert": enc, **trained}, quantizer=ttok, device="cpu")
    wav = build_synthesis_corpus(2, 3.0, seed=777001)["wav"]
    nt = float(mc["norm_threshold"])
    want, want_segs = jax_synth.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    got, got_segs = port.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    for a, b in zip(got_segs, want_segs):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
