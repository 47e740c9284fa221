"""Layer 0 of the conv frontend beyond HuBERT's (10, 5) and without a bias.

The port's ``HubertModel`` against the JAX package's, with JAX's weights
carried across (``io/checkpoint.py``), on a padded batch, at a tiny width,
fp32 / "highest": hidden states within 2e-4 (``test_torch_hubert.py``'s
bound) on the valid frames of valid items. The configurations:

- ``conv_bias=True`` (every conv with a bias, the biases drawn non-zero):
  JAX takes its standard conv + GroupNorm path; the port off autograd takes
  the fused kernel's route (on the CPU the standard path with the bias, on
  the card the kernel, where the bias of layer 0 cancels in the GroupNorm),
  under autograd the standard path;
- layer 0 at (8, 4): eligible, the fused kernel's route (its plain version
  here);
- layer 0 at (12, 5): ``k > 2 s``, the standard path in both packages;
- an input shorter than ``k0 + s0`` samples (layers 1-6 of kernel 1, so that
  the frontend still makes frames): the standard path, and JAX's warning
  where ``frontend_l0_analytic`` was asked for.

On the g++ stand-in ``test_torch_cuda_emu.py`` holds the runtime-shaped
kernels at (8, 4) and (6, 3); on the card ``chip_smoke.py --only-dispatch``.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert

TINY = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64, conv_dim=(16,) * 7,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_hidden_layers=1)
ATOL = 2e-4
CASES = {
    "conv_bias": dict(conv_bias=True),
    "k8_s4": dict(conv_kernel=(8, 3, 3, 3, 3, 2, 2), conv_stride=(4, 2, 2, 2, 2, 2, 2)),
    "k12_s5": dict(conv_kernel=(12, 3, 3, 3, 3, 2, 2)),
}


def _params(cfg_kwargs, length, seed=0):
    """JAX's init; every conv bias drawn non-zero."""
    cfg = jax_hubert.HubertConfig(**cfg_kwargs)
    params = jax.device_get(jax.jit(jax_hubert.HubertModel(cfg).init_params,
                                    static_argnums=1)(jax.random.PRNGKey(seed), length))
    rng = np.random.RandomState(seed)
    for name, node in params["feature_extractor"].items():
        if "bias" in node and name.startswith("conv_"):
            node["bias"] = (0.5 * rng.randn(*node["bias"].shape)).astype(np.float32)
    return params


def _run(cfg_kwargs, params, wav, mask, grad=False):
    """(want, got, port model): JAX's hidden states and the port's."""
    jcfg = jax_hubert.HubertConfig(precision="highest", **cfg_kwargs)
    want = np.asarray(jax.jit(jax_hubert.HubertModel(jcfg).apply)(
        {"params": params}, jnp.asarray(wav), jnp.asarray(mask)))
    model = port_hubert.HubertModel(port_hubert.HubertConfig(precision="highest", **cfg_kwargs))
    model.load_state_dict(state_dict_from_jax_params(params))
    model.eval()
    with torch.set_grad_enabled(grad):
        got = model(torch.from_numpy(wav), torch.from_numpy(mask))
    return want, got, model


def _batch(lengths, L, seed=1):
    rng = np.random.RandomState(seed)
    wav, mask = np.zeros((len(lengths), L), np.float32), np.zeros((len(lengths), L), np.int32)
    for i, n in enumerate(lengths):
        wav[i, :n], mask[i, :n] = rng.randn(n), 1
    return wav, mask


def _close_on_valid(got, want, cfg_kwargs, lengths):
    cfg = port_hubert.HubertConfig(**cfg_kwargs)
    got = got.detach().numpy()
    assert got.shape == want.shape
    for i, n in enumerate(lengths):
        t = cfg.feat_extract_output_length(n)
        np.testing.assert_allclose(got[i, :t], want[i, :t], atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_layer0_configurations_match_jax(case):
    """Off autograd (the Segmenter's route) and under autograd (the
    student's), the same weights and batch in both packages."""
    kw = dict(TINY, **CASES[case])
    lengths = [6400, 4100]
    params = _params(kw, 6400)
    wav, mask = _batch(lengths, 6400)
    want, got, model = _run(kw, params, wav, mask)
    _close_on_valid(got, want, kw, lengths)
    _, got_grad, model = _run(kw, params, wav, mask, grad=True)
    _close_on_valid(got_grad, want, kw, lengths)
    got_grad[0].sum().backward()
    convs = model.feature_extractor.convs
    if case == "conv_bias":  # every bias reaches the loss, layer 0's cancels in the GroupNorm
        assert all(c.bias.grad is not None for c in convs)
        assert float(convs[0].bias.grad.abs().max()) < 1e-3 * float(
            convs[1].bias.grad.abs().max())
    else:
        assert all(c.bias is None for c in convs)
    # the carry back to JAX's layout keeps every leaf, biases included
    back = jax_params_from_state_dict(model.state_dict())
    flat = lambda t: {"/".join(str(k.key) for k in p): v  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_input_shorter_than_k_plus_s_takes_the_standard_path():
    """Layers 1-6 of kernel 1 and stride 1, so that 12 samples (fewer than
    k0 + s0 = 15) still make 1 frame: both packages take the standard path,
    and with ``frontend_l0_analytic=True`` both warn."""
    kw = dict(TINY, conv_kernel=(10, 1, 1, 1, 1, 1, 1), conv_stride=(5, 1, 1, 1, 1, 1, 1))
    params = _params(kw, 64)
    wav, mask = _batch([12, 11], 12)
    want, got, _ = _run(kw, params, wav, mask)
    _close_on_valid(got, want, kw, [12, 11])
    cfg = port_hubert.HubertConfig(frontend_l0_analytic=True, **kw)
    assert not cfg.layer0_fused(12) and cfg.layer0_fused(15)
    model = port_hubert.HubertModel(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params))
    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        model(torch.from_numpy(wav))
    assert any("falling back to the standard conv+GroupNorm path" in str(w.message)
               for w in caught)


def _hf_names(sd):
    """A port HuBERT state dict under HF ``HubertModel``'s names (the
    positional conv as a plain weight, which the converter also takes)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"feature_extractor\.convs\.(\d+)\.(weight|bias)$", k)
        if m:
            out[f"feature_extractor.conv_layers.{m[1]}.conv.{m[2]}"] = v
            continue
        for port, hf in (("feature_extractor.group_norm.",
                          "feature_extractor.conv_layers.0.layer_norm."),
                         ("encoder_layer_norm.", "encoder.layer_norm."),
                         ("pos_conv_embed.", "encoder.pos_conv_embed."),
                         ("layers.", "encoder.layers.")):
            if k.startswith(port):
                k = hf + k[len(port):]
                break
        for name in ("intermediate_dense", "output_dense"):
            k = k.replace(f".{name}.", f".feed_forward.{name}.")
        out[k] = v
    return out


def test_hf_checkpoint_with_conv_biases_loads():
    """A checkpoint in HF ``HubertModel``'s names with a bias on every conv
    (HF's ``conv_bias=True``): the port's converter
    (``io/torch_convert.py::state_dict_from_hf``) carries every leaf across,
    the conv biases included; without them it takes the biasless layout as
    before. (The JAX package's converter has no conv biases to carry.)"""
    from sylber_tpu_torch.io.torch_convert import state_dict_from_hf

    for bias in (True, False):
        model = port_hubert.HubertModel(port_hubert.HubertConfig(conv_bias=bias, **TINY))
        port_hubert.init_weights(model, torch.Generator().manual_seed(0))
        if bias:
            for conv in model.feature_extractor.convs:
                torch.nn.init.normal_(conv.bias, 0.0, 0.5)
        sd = model.state_dict()
        back = state_dict_from_hf(_hf_names(sd), num_hidden_layers=1)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        assert all((f"feature_extractor.convs.{i}.bias" in back) == bias for i in range(7))
