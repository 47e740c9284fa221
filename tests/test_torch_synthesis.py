"""The port's ``SegmentSynthesis`` (``sylber_tpu_torch/synthesis.py``)
against ``sylber_tpu/synthesis.py`` on the CPU.

- ``resynthesize`` on the trained ``mini_synth.npz`` + ``mini_ckpt.npz``:
  the wav path (midpoint, 5 steps) gives JAX's segments and its art within
  1e-4 of the largest; the feature path with guidance (``cond_scale`` 1.5)
  too (the adaptive path: ``test_torch_synthesis_adaptive.py``).
- The segment fill and ``expand_feature`` equal JAX's.
- Refusals: a directory that is no Orbax checkpoint, a missing file, no
  GPU without ``device="cpu"``; a random-init vocoder warns (Orbax
  checkpoints load: ``test_torch_orbax.py``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu import synthesis as jsyn
from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.train.synthesis_loop import build_synthesis_corpus
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config_from_dict
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.models.voicebox import RegressorConfig
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
ART_RTOL = 1e-4  # of the largest |art|


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def mini():
    meta = json.loads((FIXTURES / "mini_synth.json").read_text())
    mc = meta["config"]["model"]
    trained = load_params_npz(str(FIXTURES / "mini_synth.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jax_synth = jsyn.SegmentSynthesis(config=jax_config_from_dict(mc), params=jsyn.SynthesisParams(
        enc, trained["input_mlp"], trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=tsyn.synthesis_config_from_dict(mc),
                                 params={"hubert": enc, **trained}, device="cpu")
    return jax_synth, port, float(mc["norm_threshold"])


def test_config_from_yaml_dict_equals_jax():
    import yaml

    cfg = yaml.safe_load((Path(__file__).parents[1] / "configs"
                          / "sylber_resynthesis.yaml").read_text())
    want, got = jsyn.SynthesisConfig.from_yaml_dict(cfg), tsyn.SynthesisConfig.from_yaml_dict(cfg)
    for field in ("encoding_layer", "input_output_dim", "input_hidden_dims",
                  "merge_threshold_range", "pitch_amp", "explicit_pitch_cond"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("dim", "depth", "dim_head", "heads", "dim_in_proj", "dim_cond_emb", "sigma",
                  "num_register_tokens", "qk_norm_scale", "rope_theta", "time_hidden"):
        assert getattr(got.regressor, field) == getattr(want.regressor, field), field
    assert got.hubert.num_hidden_layers == want.hubert.num_hidden_layers == 9


def test_wav_path_matches_jax(mini):
    jax_synth, port, nt = mini
    wav = build_synthesis_corpus(2, 3.0, seed=424242)["wav"]
    want, want_segs = jax_synth.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    got, got_segs = port.resynthesize(input_values=wav, steps=5, normthreshold=nt)
    assert len(got_segs) == len(want_segs) == 2
    for a, b in zip(got_segs, want_segs):
        np.testing.assert_array_equal(a, b)
    assert got.shape == want.shape and _rel(got, want) <= ART_RTOL


def test_feature_path_with_guidance_matches_jax(mini):
    jax_synth, port, _ = mini
    feats = np.random.RandomState(1).randn(2, 31, 144).astype(np.float32)
    feats[0, 4] = 0.0  # a blank frame stays blank
    want, none = jax_synth.resynthesize(features=feats, steps=6, cond_scale=1.5)
    got, _ = port.resynthesize(features=feats, steps=6, cond_scale=1.5)
    assert none is None and _rel(got, want) <= ART_RTOL
    plain, _ = port.resynthesize(features=feats, steps=6)
    assert np.abs(got - plain).mean() > 1e-3  # the null pass moves a trained model


def test_fill_and_expand_feature_equal_jax():
    rng = np.random.RandomState(3)
    seg_feats = rng.randn(2, 5, 6).astype(np.float32)
    segments = np.array([[[0, 3], [4, 7], [7, 9], [0, 0], [0, 0]],
                         [[1, 2], [2, 6], [8, 12], [12, 13], [0, 0]]], np.int32)
    num = np.array([3, 4], np.int32)
    want = np.asarray(jsyn._fill_from_segment_features(jnp.asarray(seg_feats),
                                                       jnp.asarray(segments), jnp.asarray(num), 14))
    got = tsyn.fill_from_segment_features(torch.from_numpy(seg_feats), torch.from_numpy(segments),
                                          torch.from_numpy(num), 14).numpy()
    np.testing.assert_array_equal(got, want)
    durations = np.array([[[2, 1], [3, 0], [1, 2]], [[1, 1], [4, 2], [0, 1]]], np.int32)
    want = np.asarray(jsyn.expand_feature(jnp.asarray(seg_feats[:, :3]), durations))
    got = tsyn.expand_feature(torch.from_numpy(seg_feats[:, :3]), durations).numpy()
    np.testing.assert_array_equal(got, want)


def test_refusals_and_the_random_vocoder_warning(tmp_path, monkeypatch):
    cfg = tsyn.SynthesisConfig(
        encoding_layer=1, regressor=RegressorConfig(
            dim=64, depth=2, dim_head=16, heads=4, dim_in_proj=8, dim_cond_emb=24,
            num_register_tokens=4, conv_pos_embed_kernel_size=5), input_output_dim=24,
        input_hidden_dims=(16,),
        hubert=tsyn.HubertConfig(num_hidden_layers=1, hidden_size=32, num_attention_heads=4,
                                 intermediate_size=64, conv_dim=(16,) * 7,
                                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="not an Orbax checkpoint"):
        tsyn.SegmentSynthesis(model_ckpt=str(tmp_path / "orbax"), config=cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        tsyn.SegmentSynthesis(model_ckpt=str(tmp_path / "absent.ckpt"), config=cfg, device="cpu")
    synth = tsyn.SegmentSynthesis(config=cfg, device="cpu")
    art, segs = synth.resynthesize(input_values=np.random.RandomState(0).randn(1, 8000),
                                   steps=2, normthreshold=0.5)
    assert art.shape == (1, 24, 14) and np.isfinite(art).all() and segs[0].ndim == 2
    with pytest.warns(UserWarning, match="random-init"):
        audio = synth.decode_audio(art, np.zeros(64, np.float32))
    assert audio.shape == (1, 24 * 320) and np.isfinite(audio).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.SegmentSynthesis(config=cfg)
