"""The port's vocoder training half (``sylber_tpu_torch/vocoder/hifigan.py``)
against ``sylber_tpu/vocoder/hifigan.py`` on the CPU, fp32 (the grouped
convs of the scale discriminator are checked in fp32 only).

- The multi-period and multi-scale discriminators on converted weights:
  logits and every feature map within 2e-5 of the largest, at a length
  where the period pads and the ``"SAME"`` pads are odd, and at one where
  the period pad exceeds L - 1 (zero padding).
- The weight carry of the discriminators gives back the same arrays.
- The step runs in float64 on a ``.double()`` state (the form in which the
  card is held to the CPU): every tensor stays float64, and the losses lie
  within 1e-5 of the float32 step's.

One train step: ``test_torch_vocoder_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.vocoder import hifigan as jh
from sylber_tpu_torch.io.checkpoint import (discriminator_state_dicts_from_jax,
                                            jax_tree_from_discriminators)
from sylber_tpu_torch.vocoder import hifigan as th


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the test workers share the machine's cores (more
    threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_discriminators():
    """Seeded JAX discriminators: the modules and their tree."""
    wav = jnp.zeros((1, 640))
    mpd, msd = jh.MultiPeriodDiscriminator(), jh.MultiScaleDiscriminator()
    return mpd, msd, {
        "mpd": jax.device_get(jax.jit(mpd.init)(jax.random.PRNGKey(1), wav)["params"]),
        "msd": jax.device_get(jax.jit(msd.init)(jax.random.PRNGKey(2), wav)["params"])}


@pytest.fixture(scope="module")
def discs():
    mpd, msd, tree = jax_discriminators()
    sds = discriminator_state_dicts_from_jax(tree)
    tmpd, tmsd = th.MultiPeriodDiscriminator(), th.MultiScaleDiscriminator()
    tmpd.load_state_dict(sds["mpd"])
    tmsd.load_state_dict(sds["msd"])
    return (mpd, msd, tree), (tmpd, tmsd)


@pytest.mark.parametrize("L", [2001, 4])
def test_discriminators_match_jax(discs, L):
    (mpd, msd, tree), (tmpd, tmsd) = discs
    wav = np.random.RandomState(L).randn(2, L).astype(np.float32) * 0.3
    if L > 11:  # odd pads: period 2 pads 1, 3 pads 0, 5 pads 4, 7 pads 1, 11 pads 1
        assert any((-L) % p % 2 for p in (2, 7, 11)) and L % 2 == 1
    else:      # period 11 pads 7 > L - 1: zero padding
        assert (-L) % 11 > L - 1
    for jmod, jparams, tmod, channels_last in ((mpd, tree["mpd"], tmpd, (0, 2, 3, 1)),
                                               (msd, tree["msd"], tmsd, (0, 2, 1))):
        want_l, want_f = jmod.apply({"params": jparams}, jnp.asarray(wav))
        with torch.no_grad():
            got_l, got_f = tmod(torch.from_numpy(wav))
        for g, w in zip(got_l, want_l):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g.numpy() - w).max() <= 2e-5 * max(np.abs(w).max(), 1e-6)
        n = 0
        for gf, wf in zip(got_f, want_f):
            for g, w in zip(gf, wf):
                g, w = g.numpy().transpose(channels_last), np.asarray(w)
                assert g.shape == w.shape
                assert np.abs(g - w).max() <= 2e-5 * max(np.abs(w).max(), 1e-6)
                n += 1
        assert n == (25 if jmod is mpd else 21)


def test_discriminator_weight_carry_is_exact(discs):
    (_, _, tree), (tmpd, tmsd) = discs
    back = jax_tree_from_discriminators({"mpd": tmpd.state_dict(), "msd": tmsd.state_dict()})
    a, b = _flat(back), _flat(tree)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_vocoder_step_keeps_float64():
    import json
    from pathlib import Path

    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu_torch.io.checkpoint import generator_state_dict_from_jax
    from sylber_tpu_torch.vocoder.mel import log_mel

    fixtures = Path(__file__).parent / "fixtures"
    meta = json.loads((fixtures / "mini_vocoder.json").read_text())
    vcfg = th.VocoderTrainConfig(model=th.HiFiGANConfig(**meta["generator"]))
    gen = generator_state_dict_from_jax(load_params_npz(str(fixtures / "mini_vocoder.npz")))
    rng = np.random.RandomState(0)
    B, T = 2, 8
    host = {"f": rng.randn(B, T, 14) * 0.5, "w": rng.randn(B, T * 320) * 0.3,
            "c": rng.randn(B, 64), "n": rng.randn(B, T * 320)}
    host["f"][..., 12] = np.log(2.5)
    losses = {}
    for dtype in (torch.float32, torch.float64):
        init_fn, step_fn = th.make_vocoder_train_step(vcfg, precision="highest")
        state = init_fn("cpu", seed=3, generator_state=gen)
        for m in (state.generator, state.mpd, state.msd):
            m.to(dtype)
        v = {k: torch.from_numpy(a).to(dtype) for k, a in host.items()}
        with torch.no_grad():
            fake = state.generator(v["f"], v["c"], noise=v["n"])
        assert fake.dtype == dtype and log_mel(fake).dtype == dtype
        losses[dtype] = {k: float(t) for k, t in step_fn(state, v["f"], v["w"], v["c"],
                                                         noise=v["n"]).items()}
        for m in (state.generator, state.mpd, state.msd):
            assert {p.dtype for p in m.parameters()} == {dtype}
            assert {p.grad.dtype for p in m.parameters()} == {dtype}
    for k, want in losses[torch.float64].items():
        np.testing.assert_allclose(losses[torch.float32][k], want, rtol=1e-5, err_msg=k)
