"""The port's HuBERT encoder and weight bridges against the JAX package.

Hidden states of ``sylber_tpu_torch.models.hubert.HubertModel`` must match
``sylber_tpu.models.hubert.HubertModel`` at atol 2e-4 in fp32 / highest, on
valid frames of valid items, with the same weights: seeded JAX weights at a
small width, the trained ``mini_ckpt.npz`` fixture, and an HF
``HubertModel`` state dict converted by both packages.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu_torch.io.checkpoint import load_params_npz, state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert

FIXTURES = Path(__file__).parent / "fixtures"
SMALL = dict(hidden_size=48, num_attention_heads=4, intermediate_size=96,
             conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, num_hidden_layers=2)


def _port_model(cfg_kwargs, params):
    model = port_hubert.HubertModel(port_hubert.HubertConfig(**cfg_kwargs))
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval()


def _batch(rng, lengths, L):
    wav = np.zeros((len(lengths), L), np.float32)
    mask = np.zeros((len(lengths), L), np.int32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.randn(n)
        mask[i, :n] = 1
    return wav, mask


def _compare(cfg_kwargs, params, lengths, L, seed):
    rng = np.random.RandomState(seed)
    wav, mask = _batch(rng, lengths, L)
    jcfg = jax_hubert.HubertConfig(precision="highest", **cfg_kwargs)
    want = np.asarray(jax_hubert.HubertModel(jcfg).apply(
        {"params": params}, jnp.asarray(wav), jnp.asarray(mask)))
    with torch.no_grad():
        got = _port_model(cfg_kwargs, params)(torch.from_numpy(wav),
                                              torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    for i, n in enumerate(lengths):
        t = jcfg.feat_extract_output_length(n)
        np.testing.assert_allclose(got[i, :t], want[i, :t], atol=2e-4, rtol=0)


def test_small_config_padded_batch_matches_jax():
    params = jax_hubert.HubertModel(jax_hubert.HubertConfig(**SMALL)).init_params(
        jax.random.PRNGKey(0), 8000)
    _compare(SMALL, params, [8000, 5100, 2300], 8000, seed=0)


def test_mini_ckpt_matches_jax():
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    params = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    _compare(hub, params, [16000, 9000], 16000, seed=1)


def test_npz_reader_matches_jax_reader():
    path = str(FIXTURES / "mini_ckpt.npz")
    ours, theirs = load_params_npz(path), jax_load_npz(path)
    flat = lambda t: {"/".join(str(k.key) for k in p): v  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(ours), flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k


def test_jax_tree_bridge_layouts():
    """Dense (in, out) -> (out, in); grouped Conv (k, in/g, out) -> (out, in/g, k);
    scale -> weight; masked_spec_embed carried; every port parameter filled."""
    params = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    sd = state_dict_from_jax_params(params)
    pos = params["pos_conv_embed"]["conv"]["kernel"]
    assert pos.shape == (64, 9, 144)
    np.testing.assert_array_equal(sd["pos_conv_embed.conv.weight"].numpy(),
                                  np.transpose(pos, (2, 1, 0)))
    q = params["layer_3"]["attention"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["layers.3.attention.q_proj.weight"].numpy(), q.T)
    np.testing.assert_array_equal(sd["feature_extractor.group_norm.weight"].numpy(),
                                  params["feature_extractor"]["group_norm"]["scale"])
    np.testing.assert_array_equal(sd["masked_spec_embed"].numpy(),
                                  params["masked_spec_embed"])
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    model = port_hubert.HubertModel(port_hubert.HubertConfig(**hub))
    assert set(model.state_dict()) == set(sd)


def test_hf_state_dict_conversion_matches_jax(tmp_path):
    """An HF HubertModel checkpoint (weight-normed positional conv) loads into
    both packages and gives the same hidden states."""
    transformers = pytest.importorskip("transformers")
    from sylber_tpu.io.torch_convert import load_torch_checkpoint as jax_load_torch
    from sylber_tpu_torch.io.torch_convert import load_torch_checkpoint

    torch.manual_seed(0)
    hf_cfg = transformers.HubertConfig(
        hidden_size=SMALL["hidden_size"], num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=96, conv_dim=(32,) * 7,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    hf = transformers.HubertModel(hf_cfg).eval()
    path = tmp_path / "hf.ckpt"
    torch.save({"state_dict": {f"net.speech_model.{k}": v
                               for k, v in hf.state_dict().items()}}, path)

    params = jax_load_torch(str(path), num_hidden_layers=2)
    model = port_hubert.HubertModel(port_hubert.HubertConfig(**SMALL))
    model.load_state_dict(load_torch_checkpoint(str(path), num_hidden_layers=2))
    wav = np.random.RandomState(4).randn(1, 6400).astype(np.float32)
    want = np.asarray(jax_hubert.HubertModel(jax_hubert.HubertConfig(**SMALL)).apply(
        {"params": params}, jnp.asarray(wav)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(wav)).numpy()
        ref = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
