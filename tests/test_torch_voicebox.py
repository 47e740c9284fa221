"""The port's voicebox ``Regressor`` (``sylber_tpu_torch/models/voicebox.py``)
against ``sylber_tpu/models/voicebox.py`` on the CPU, fp32.

Same weights (the trained ``mini_synth.npz``, with the skip combiners of a
JAX init where the skips are on), same seeded inputs: outputs within 1e-5
of the largest, with U-Net skips on and off and with and without a prefix
mask.
Also: the RoPE inverse frequencies and angles equal JAX's bit for bit (the
registers sit at position -10000), the weight carry of
``io/checkpoint.py`` gives back the same arrays bit for bit, a mask
that is not a prefix raises, and a regressor with gateloop layers builds
and runs (``test_torch_gateloop.py`` holds it against JAX).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_params_npz
from sylber_tpu.models import voicebox as jvb
from sylber_tpu_torch.io.checkpoint import (load_params_npz, save_tree_npz,
                                            state_dict_from_tree, synthesis_state_dict_from_jax,
                                            tree_from_state_dict)
from sylber_tpu_torch.models import voicebox as tvb
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
MINI = dict(depth=4, dim=128, heads=4, dim_head=32, dim_in_proj=32, dim_cond_emb=64)
SMALL = dict(depth=4, dim=64, heads=4, dim_head=16, dim_in_proj=16, dim_cond_emb=24)
RTOL = 1e-5  # of the output's largest magnitude


def _close(got, want, rtol=RTOL):
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(B, L, cfg, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L, cfg["dim_out"] if "dim_out" in cfg else 14).astype(np.float32),
            rng.randn(B, L, cfg["dim_cond_emb"]).astype(np.float32),
            rng.uniform(0, 1, B).astype(np.float32))


def _trained_params(skips: bool):
    """The trained ``mini_synth.npz`` regressor; with ``skips`` the U-Net
    skip combiners of a JAX init of that configuration are added. (A random
    init of the whole regressor is no yardstick at depth 4: its sharp
    scale-10 attention moves JAX's own output by 1.7e-4 of the largest when
    the input moves by one ulp.)"""
    params = jax_load_params_npz(str(FIXTURES / "mini_synth.npz"))["regressor"]
    if skips:
        cfg = jvb.RegressorConfig(**MINI, use_unet_skip_connection=True)
        x, emb, _ = _inputs(1, 8, MINI)
        init = jax.device_get(jvb.Regressor(cfg).init(
            jax.random.PRNGKey(1), jnp.asarray(x), jnp.zeros((1,)),
            cond_emb=jnp.asarray(emb))["params"])
        for name, node in init["transformer"].items():
            if name.startswith("skip_combiner"):
                params["transformer"][name] = node
    return params


def _run_both(cfg_kw, params, x, emb, times, mask=None):
    model = jvb.Regressor(jvb.RegressorConfig(**cfg_kw))
    want = np.asarray(model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(times), cond_emb=jnp.asarray(emb),
        self_attn_mask=None if mask is None else jnp.asarray(mask)))
    port = tvb.Regressor(tvb.RegressorConfig(**cfg_kw))
    port.load_state_dict(synthesis_state_dict_from_jax({"regressor": params,
                                                        "input_mlp": {}})["regressor"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.as_tensor(times), cond_emb=torch.from_numpy(emb),
                   self_attn_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    return got, want


@pytest.mark.parametrize("dim_head", [8, 16, 32, 64, 128])
def test_rope_frequencies_equal_jax_bit_for_bit(dim_head):
    positions = np.concatenate([np.full(16, -10000.0, np.float32),
                                np.arange(1100, dtype=np.float32)])
    want = np.asarray(jvb.rope_frequencies(jnp.asarray(positions), dim_head, 50000.0))
    inv = torch.from_numpy(tvb.rope_inverse_frequencies(dim_head, 50000.0))
    got = tvb.rope_frequencies(torch.from_numpy(positions), inv).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("skips", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_regressor_matches_jax(skips, masked):
    """Per-row times, and a batch whose rows stop at three lengths."""
    cfg_kw = dict(MINI, use_unet_skip_connection=skips)
    x, emb, times = _inputs(3, 53, cfg_kw, seed=2)
    mask = None
    if masked:
        mask = np.ones((3, 53), bool)
        mask[1, 40:] = False
        mask[2, 11:] = False
    got, want = _run_both(cfg_kw, _trained_params(skips), x, emb, times, mask)
    _close(got, want)


def test_mask_must_be_a_prefix_and_other_refusals():
    cfg = tvb.RegressorConfig(**SMALL)
    model = tvb.Regressor(cfg)
    x, emb, _ = _inputs(1, 9, SMALL)
    mask = np.ones((1, 9), bool)
    mask[0, 3] = False  # a hole: not a prefix
    with pytest.raises(RuntimeError, match="prefix"):
        model(torch.from_numpy(x), 0.5, cond_emb=torch.from_numpy(emb),
              self_attn_mask=torch.from_numpy(mask))
    gated = tvb.Regressor(tvb.RegressorConfig(**SMALL, use_gateloop_layers=True)).eval()
    assert len([m for m in gated.modules() if isinstance(m, tvb.SimpleGateLoop)]) == 4
    with torch.no_grad():
        out = gated(torch.from_numpy(x), 0.5, cond_emb=torch.from_numpy(emb))
    assert out.shape == (1, 9, 14) and torch.isfinite(out).all()


def test_synthesis_weight_carry_round_trip_is_bit_exact(tmp_path):
    tree = load_params_npz(str(FIXTURES / "mini_synth.npz"))
    sds = synthesis_state_dict_from_jax(tree)
    model = tvb.Regressor(tvb.RegressorConfig(**MINI))
    model.load_state_dict(sds["regressor"])  # every leaf has its slot
    back = {name: tree_from_state_dict(sd) for name, sd in sds.items()}
    save_tree_npz(str(tmp_path / "synth.npz"), back)
    again = jax_load_params_npz(str(tmp_path / "synth.npz"))  # the JAX package reads it
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    a, b = flat(tree), flat(again)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), path
    # a state dict of the module itself goes back to the same tree
    sd = {k: v for k, v in model.state_dict().items()}
    for key, value in state_dict_from_tree(tree_from_state_dict(sd)).items():
        assert torch.equal(value, sd[key]), key


def test_regressor_times_forms_agree():
    """A number, a 0-d tensor and a (B,) tensor of one time give one output."""
    model = tvb.init_regressor(tvb.Regressor(tvb.RegressorConfig(**SMALL)),
                               torch.Generator().manual_seed(0))
    x, emb, _ = _inputs(2, 11, SMALL)
    x, emb = torch.from_numpy(x), torch.from_numpy(emb)
    with torch.no_grad():
        a = model(x, 0.25, cond_emb=emb)
        b = model(x, torch.tensor(0.25), cond_emb=emb)
        c = model(x, torch.full((2,), 0.25), cond_emb=emb)
    assert torch.equal(a, b) and torch.equal(a, c) and torch.isfinite(a).all()
    assert dataclasses.replace(model.cfg, depth=2).time_hidden == 4 * SMALL["dim"]
