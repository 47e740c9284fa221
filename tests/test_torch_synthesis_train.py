"""The port's resynthesis train step (``sylber_tpu_torch/synthesis.py``)
against ``sylber_tpu/synthesis.py::make_synthesis_train_step`` on the CPU,
fp32, TF32 off.

From the trained ``mini_synth.npz`` on ``mini_ckpt.npz`` (a random-init
regressor at the softmax scale of 10 is no yardstick: its output moves
1.7e-4 of its largest in JAX itself for one ulp of input), with the input
MLP's dropout at 0 so the two steps see the same masks and with JAX's
draws (``split(rng, 4)`` of each step's key) handed to the port: the loss
within rtol 1e-5, every gradient leaf within 1e-4 of the largest
gradient (three whole updates: ``test_torch_synthesis_train_steps.py``).
Also a step of the explicit-pitch model (``mini_synth_rich_pitch.npz``) and
the input MLP's train-mode dropout.

JAX runs op by op (``jax.disable_jit``): its jitted gradient differs from
its own op-by-op one by 2.9e-4 of the largest gradient, at layer 0's
``to_qkv`` kernel (XLA's fusions round the scale-10 attention's scores
otherwise, and four such layers amplify it), while the port lies within
1.3e-5 of the op-by-op one and its own float32 gradient within 6.2e-6 of
its float64 one.
"""

import dataclasses
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
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.flow.cfm import CFMDraws
from sylber_tpu_torch.io.checkpoint import tree_from_state_dict

FIXTURES = Path(__file__).parent / "fixtures"
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the test workers share the machine's cores (more
    threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def jax_draws(rng, shape):
    B = shape[0]
    k0, kt, km, _ = jax.random.split(rng, 4)
    k1, k2 = jax.random.split(km)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return CFMDraws(as_t(jax.random.normal(k0, shape, jnp.float32)),
                    as_t(jax.random.uniform(kt, (B,), jnp.float32)),
                    as_t(jax.random.uniform(k1, (B,))), as_t(jax.random.uniform(k2, (B,))), 0)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def port_grad_tree(synth):
    return {name: tree_from_state_dict({k: p.grad for k, p in m.named_parameters()})
            for name, m in (("input_mlp", synth.input_mlp), ("regressor", synth.regressor))}


def worst_leaf(got, want):
    """(leaf, its largest difference over the tree's largest magnitude)."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    scale = max(np.abs(v).max() for v in w.values())
    errs = {k: float(np.abs(g[k] - w[k]).max()) / scale for k in w}
    k = max(errs, key=errs.get)
    return k, errs[k]


def pair(name):
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    mc = meta["config"]["model"]
    trained = load_params_npz(str(FIXTURES / f"{name}.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jc = dataclasses.replace(jax_config(mc), input_dropout=0.0)
    pc = dataclasses.replace(tsyn.synthesis_config_from_dict(mc), input_dropout=0.0)
    pc = dataclasses.replace(pc, regressor=dataclasses.replace(pc.regressor, precision="highest"))
    jsynth = jsyn.SegmentSynthesis(config=jc, params=jsyn.SynthesisParams(
        enc, trained["input_mlp"], trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=pc, params={"hubert": enc, **trained}, device="cpu")
    return jsynth, port


def batch_of(B=4, seconds=1.2, pitch=False, masked=False, seed=0):
    """Averaged/blanked features of random segments, the corpus's art."""
    rng = np.random.RandomState(seed)
    art = build_synthesis_corpus(B, seconds, seed=seed)["art"]
    L = art.shape[1]
    feats = np.zeros((B, L, 144), np.float32)
    for b in range(B):
        t = 2
        while t < L - 3:
            n = rng.randint(3, 12)
            if rng.rand() > 0.15:
                feats[b, t:t + n] = rng.randn(144) * 0.4
            t += n
    batch = {"features": feats, "art": art.astype(np.float32)}
    if pitch:
        batch["pitch_cond"] = (rng.randn(B, L) * 0.2 * (feats[..., 0] != 0)).astype(np.float32)
    if masked:
        batch["mask"] = (np.arange(L)[None] < np.array([L, L - 9, L - 20, L])[:B, None]).astype(
            np.float32)
    return batch


@pytest.fixture(scope="module")
def mini():
    return pair("mini_synth")


def _check_step(jsynth, port, batch, grads=True):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)

    def jloss(trainable):
        params = jsyn.SynthesisParams(jsynth.params.hubert, trainable["input_mlp"],
                                      trainable["regressor"])
        return jsynth.loss(params, jb, rng)

    trainable = {"input_mlp": jsynth.params.input_mlp, "regressor": jsynth.params.regressor}
    with jax.disable_jit():
        want_loss, want_grads = jax.value_and_grad(jloss)(trainable)
    for m in port.trainable_modules():
        m.train()
        m.zero_grad()
    got_loss = port.loss(tb, jax_draws(rng, batch["art"].shape))
    got_loss.backward()
    got_loss = got_loss.detach()
    for m in port.trainable_modules():
        m.eval()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=LOSS_RTOL)
    if grads:
        leaf, err = worst_leaf(port_grad_tree(port), jax.device_get(want_grads))
        assert err <= GRAD_RTOL, (leaf, err)


def test_loss_and_gradients_match_jax(mini):
    _check_step(*mini, batch_of())


def test_loss_with_a_padding_mask_matches_jax(mini):
    """The loss only: with a padding mask both packages' gradients are NaN
    (the regressor's RMS norm takes the square root of the zeroed padded
    frames' sum of squares; no shipped recipe passes a mask)."""
    _check_step(*mini, batch_of(masked=True, seed=1), grads=False)


def test_explicit_pitch_step_matches_jax():
    jsynth, port = pair("mini_synth_rich_pitch")
    _check_step(jsynth, port, batch_of(pitch=True, seed=2))
    with pytest.raises(ValueError, match="pitch_cond"):
        b = batch_of(seed=2)
        port.loss({k: torch.from_numpy(v) for k, v in b.items()},
                  jax_draws(jax.random.PRNGKey(0), b["art"].shape))


def test_train_mode_input_dropout_draws_from_the_seed():
    _, port = pair("mini_synth")
    port.input_mlp.rff_0.dropout = 0.05
    x = torch.randn(2, 9, 144)
    port.input_mlp.train()
    from sylber_tpu_torch.ops.attention import Dropout

    a = port.input_mlp(x, Dropout(1, "cpu"))
    b = port.input_mlp(x, Dropout(1, "cpu"))
    c = port.input_mlp(x, Dropout(2, "cpu"))
    port.input_mlp.eval()
    d = port.input_mlp(x, Dropout(2, "cpu"))
    e = port.input_mlp(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)
