"""The port's converters of reference PyTorch synthesis checkpoints
(``sylber_tpu_torch/io/torch_convert.py``) against ``sylber_tpu/io/torch_convert.py``.

The cases of ``tests/unit/test_torch_convert_synthesis.py`` run against the
port: a state dict with the reference ``Regressor``'s and input MLP's names
and layouts loads into the port's modules, whose outputs equal the
JAX-converted models' (1e-5); a whole reference ``SegmentSynthesis``
checkpoint (an HF encoder, the input MLP, the regressor) loads with the
weights the JAX converter gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu import synthesis as jsyn
from sylber_tpu.io import torch_convert as jconv
from sylber_tpu.models.voicebox import Regressor as JRegressor
from sylber_tpu.models.voicebox import RegressorConfig as JRegressorConfig
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.io import torch_convert as tconv
from sylber_tpu_torch.io.checkpoint import synthesis_state_dict_from_jax
from sylber_tpu_torch.models.voicebox import Regressor, RegressorConfig
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


CFG = dict(dim=64, depth=2, dim_head=16, heads=4, dim_in_proj=8, dim_cond_emb=24, dim_out=14,
           num_register_tokens=4, conv_pos_embed_kernel_size=5)


def _fake_regressor_sd(rng, prefix="regressor."):
    """The reference Regressor's names and torch layouts (the state dict of
    ``tests/unit/test_torch_convert_synthesis.py``)."""
    c = JRegressorConfig(**CFG)
    inner, ffn = c.dim_head * c.heads, int(c.dim * c.ff_mult * 2 / 3)
    sd = {f"{prefix}proj_in.weight": rng.randn(c.dim_in_proj, c.dim_out),
          f"{prefix}proj_in.bias": rng.randn(c.dim_in_proj),
          f"{prefix}sinu_pos_emb.0.weights": rng.randn(c.dim // 2),
          f"{prefix}sinu_pos_emb.1.weight": rng.randn(c.time_hidden, c.dim) * 0.1,
          f"{prefix}sinu_pos_emb.1.bias": rng.randn(c.time_hidden),
          f"{prefix}to_embed.weight": rng.randn(c.dim, c.dim_in_proj * 2 + c.dim_cond_emb) * 0.1,
          f"{prefix}to_embed.bias": rng.randn(c.dim),
          f"{prefix}conv_embed.dw_conv1d.0.weight": rng.randn(c.dim, 1,
                                                              c.conv_pos_embed_kernel_size),
          f"{prefix}conv_embed.dw_conv1d.0.bias": rng.randn(c.dim),
          f"{prefix}to_pred.weight": rng.randn(c.dim_out, c.dim) * 0.1,
          f"{prefix}transformer.register_tokens": rng.randn(c.num_register_tokens, c.dim),
          f"{prefix}transformer.final_norm.gamma": rng.randn(c.dim)}
    for i in range(c.depth):
        lp = f"{prefix}transformer.layers.{i}."
        for slot in ("2", "4"):
            sd[lp + slot + ".to_gamma.weight"] = rng.randn(c.dim, c.time_hidden) * 0.01
            sd[lp + slot + ".to_gamma.bias"] = 1 + 0.1 * rng.randn(c.dim)
            sd[lp + slot + ".to_beta.weight"] = rng.randn(c.dim, c.time_hidden) * 0.01
            sd[lp + slot + ".to_beta.bias"] = 0.1 * rng.randn(c.dim)
        sd.update({lp + "3.to_qkv.weight": rng.randn(inner * 3, c.dim) * 0.1,
                   lp + "3.to_out.weight": rng.randn(c.dim, inner) * 0.1,
                   lp + "3.q_norm.gamma": 1 + 0.1 * rng.randn(c.heads, 1, c.dim_head),
                   lp + "3.k_norm.gamma": 1 + 0.1 * rng.randn(c.heads, 1, c.dim_head),
                   lp + "5.0.weight": rng.randn(ffn * 2, c.dim) * 0.1,
                   lp + "5.0.bias": rng.randn(ffn * 2) * 0.1,
                   lp + "5.3.weight": rng.randn(c.dim, ffn) * 0.1,
                   lp + "5.3.bias": rng.randn(c.dim) * 0.1})
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _fake_input_mlp_sd(rng, in_dim, hidden, out_dim, prefix="input_model."):
    sd, dims = {}, [in_dim] + list(hidden)
    for i, h in enumerate(hidden):
        sd[f"{prefix}mlp.{2 * i}.weight"] = rng.randn(h, dims[i]) * 0.2
        sd[f"{prefix}mlp.{2 * i}.bias"] = rng.randn(h)
        for lin in ("linear1", "linear2"):
            sd[f"{prefix}mlp.{2 * i + 1}.{lin}.weight"] = rng.randn(h, h) * 0.2
            sd[f"{prefix}mlp.{2 * i + 1}.{lin}.bias"] = rng.randn(h)
        sd[f"{prefix}mlp.{2 * i + 1}.norm.weight"] = rng.randn(h)
        sd[f"{prefix}mlp.{2 * i + 1}.norm.bias"] = rng.randn(h)
    sd[f"{prefix}mlp.{2 * len(hidden)}.weight"] = rng.randn(out_dim, hidden[-1]) * 0.2
    sd[f"{prefix}mlp.{2 * len(hidden)}.bias"] = rng.randn(out_dim)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_regressor_conversion_matches_jax():
    sd = _fake_regressor_sd(np.random.RandomState(0))
    port = Regressor(RegressorConfig(**CFG))
    port.load_state_dict(tconv.regressor_params_from_torch(sd, depth=CFG["depth"]))
    params = jconv.regressor_params_from_torch(sd, depth=CFG["depth"])
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 14).astype(np.float32)
    emb = rng.randn(2, 6, CFG["dim_cond_emb"]).astype(np.float32)
    want = np.asarray(JRegressor(JRegressorConfig(**CFG)).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(0.5), cond_emb=jnp.asarray(emb)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.5, cond_emb=torch.from_numpy(emb)).numpy()
    assert got.shape == (2, 6, 14) and _rel(got, want) <= 1e-5


def test_input_mlp_conversion_and_rff_match_jax():
    rng = np.random.RandomState(1)
    hidden, in_dim, out_dim = (20, 20), 12, 8
    sd = _fake_input_mlp_sd(rng, in_dim, hidden, out_dim)
    port = tsyn.InputMLP(in_dim, out_dim, hidden)
    port.load_state_dict(tconv.input_mlp_params_from_torch(sd, n_hidden=len(hidden)))
    params = jconv.input_mlp_params_from_torch(sd, n_hidden=len(hidden))
    x = rng.randn(2, 5, in_dim).astype(np.float32)
    want = np.asarray(jsyn.InputMLP(output_dim=out_dim, hidden_dims=hidden).apply(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_load_synthesis_checkpoint_matches_jax(tmp_path):
    """A reference SegmentSynthesis checkpoint (an HF encoder under
    ``net.speech_model.``, the input MLP and the regressor) loads into the
    port with the same weights the JAX converter gives."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.HubertModel(transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    rng = np.random.RandomState(2)
    flat = {f"speech_model.{k}": v for k, v in hf.state_dict().items()}
    flat.update({k: torch.from_numpy(v) for k, v in _fake_regressor_sd(rng).items()})
    flat.update({k: torch.from_numpy(v) for k, v in
                 _fake_input_mlp_sd(rng, 32, (16,), CFG["dim_cond_emb"]).items()})
    path = tmp_path / "synthesis.ckpt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in flat.items()}}, path)

    from sylber_tpu_torch.models.hubert import HubertConfig

    cfg = tsyn.SynthesisConfig(
        encoding_layer=1, regressor=RegressorConfig(**CFG), input_output_dim=CFG["dim_cond_emb"],
        input_hidden_dims=(16,), hubert=HubertConfig(
            num_hidden_layers=1, hidden_size=32, num_attention_heads=4, intermediate_size=64,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    port = tsyn.SegmentSynthesis(model_ckpt=str(path), config=cfg, device="cpu")
    want = jconv.load_synthesis_checkpoint(str(path), cfg)
    want_sds = synthesis_state_dict_from_jax({"hubert": want.hubert,
                                              "input_mlp": want.input_mlp,
                                              "regressor": want.regressor})
    for name in ("input_mlp", "regressor"):
        got_sd = getattr(port, name).state_dict()
        assert set(got_sd) == set(want_sds[name]), name
        for key, value in want_sds[name].items():
            assert torch.equal(got_sd[key], value), key
    got_sd = port.hubert.state_dict()
    for key, value in want_sds["hubert"].items():
        assert torch.allclose(got_sd[key], value, rtol=1e-6, atol=1e-7), key
