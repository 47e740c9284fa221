"""One step of the port's ``make_vocoder_train_step``
(``sylber_tpu_torch/vocoder/hifigan.py``) against JAX's
(``sylber_tpu/vocoder/hifigan.py``) on the CPU, fp32, TF32 off: the
trained ``mini_vocoder.npz`` generator with its harmonic source, JAX's
seeded discriminators, JAX's source noise. The pitch is 250 Hz in every
frame: the source's phase then advances by 2^-6 a sample and its running
sum is exact in float32 in any order. (At other pitches XLA's jitted
gradient differs from its own op-by-op one by 3e-3 of the largest, the
float32 phase sum rounding apart inside the fused step; the port, which
sums the phase in float64, lies within 1.8e-6 of the op-by-op one.)

- The five losses within rtol 1e-5.
- The discriminators' gradient, and the generator's against the same
  updated discriminators: the tree's L2 difference, and its largest
  element's, within 2e-3 of the tree's. Leaky ReLU's slope jumps from 0.1
  to 1 at 0, and with a million pre-activations some lie within float32
  rounding of 0: here one of period 2's conv_4 (1.5e-9 on the real
  waveform) takes the other slope in oneDNN's convolution than in XLA's,
  which moves that discriminator's whole gradient by 1.1e-3 (L2) of the
  tree; the generator's is within 1.6e-4 (L2), 2e-4 (largest). (JAX's own
  jitted and op-by-op gradients share XLA's convolution: 1e-7.)
- The updated parameters: Adam's first step moves an element by
  lr g / (|g| + eps), about lr times the sign of its gradient, so an element
  whose gradient is near 0, or that feels the slope above, may move either
  way. No element moves more than lr (1e-3 over, for the rounding of the
  difference), and at least 99.8 % of each tree's elements are within 1e-5
  of JAX's (67 of the generator's 956,785 are not).

The JAX functions are compiled at XLA's optimisation level 0: compiling the
whole step at the default level takes 45 s on the CPU, running it op by op
140 s.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.vocoder import hifigan as jh
from sylber_tpu.vocoder.mel import log_mel as jax_log_mel
from sylber_tpu_torch.io.checkpoint import (discriminator_state_dicts_from_jax,
                                            generator_state_dict_from_jax,
                                            jax_tree_from_discriminators, jax_tree_from_generator)
from sylber_tpu_torch.vocoder import hifigan as th
from test_torch_vocoder_train import _few_threads, _flat, jax_discriminators  # noqa: E402,F401

FIXTURES = Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "mini_vocoder.json").read_text())
OPT0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPT0)(*args)


def gradient_errors(got, want):
    """(the whole tree's L2 difference over its L2 norm, the worst leaf and
    its largest difference over the tree's largest magnitude)."""
    g, w = _flat(got), _flat(want)
    scale = max(np.abs(v).max() for v in w.values())
    errs = {k: float(np.abs(g[k] - w[k]).max()) / scale for k in w}
    k = max(errs, key=errs.get)
    l2 = np.sqrt(sum(float(((g[k] - w[k]).astype(np.float64) ** 2).sum()) for k in w))
    return l2 / np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in w.values())), k, errs[k]


@pytest.fixture(scope="module")
def setup():
    gcfg = META["generator"]
    jcfg = jh.VocoderTrainConfig(model=jh.HiFiGANConfig(**gcfg))
    gen = load_params_npz(str(FIXTURES / "mini_vocoder.npz"))
    mpd, msd, dtree = jax_discriminators()
    T, B = 8, 2
    rng = np.random.RandomState(0)
    feats = rng.randn(B, T, 14).astype(np.float32) * 0.5
    feats[..., 12] = np.float32(np.log(2.5))  # 100 exp(x) is 250.0 in both packages
    wav = (np.sin(np.arange(T * 320) * 0.05)[None] * rng.uniform(0.2, 0.6, (B, 1))
           + 0.01 * rng.randn(B, T * 320)).astype(np.float32)
    cond = rng.randn(B, 64).astype(np.float32)
    return jcfg, gen, (mpd, msd, dtree), (feats, wav, cond)


def test_vocoder_train_step_matches_jax(setup):
    jcfg, gen, (mpd, msd, dtree), (feats, wav, cond) = setup
    jf, jw, jc = jnp.asarray(feats), jnp.asarray(wav), jnp.asarray(cond)
    _, step_fn = jh.make_vocoder_train_step(jcfg)
    # init_fn's state, its parameters replaced (an eager flax init takes 30 s)
    tx = optax.adam(jcfg.lr, b1=jcfg.adam_b1, b2=jcfg.adam_b2)
    g0, d0 = jax.tree.map(jnp.asarray, gen), jax.tree.map(jnp.asarray, dtree)
    state = {"gen": g0, "disc": d0, "opt_gen": tx.init(g0), "opt_disc": tx.init(d0)}
    new, want = compiled(step_fn, state, jf, jw, jc)

    # JAX's gradients: the discriminators' from the start, the generator's
    # against JAX's updated discriminators
    G = jh.Generator(jcfg.model)
    fake = compiled(lambda g: G.apply({"params": g}, jf, jc), state["gen"])

    def d_loss(d):
        rl_p, _ = mpd.apply({"params": d["mpd"]}, jw)
        fl_p, _ = mpd.apply({"params": d["mpd"]}, fake)
        rl_s, _ = msd.apply({"params": d["msd"]}, jw)
        fl_s, _ = msd.apply({"params": d["msd"]}, fake)
        return jh.discriminator_loss(rl_p + rl_s, fl_p + fl_s)

    def g_loss(g, d):
        wf = G.apply({"params": g}, jf, jc)
        fl_p, ff_p = mpd.apply({"params": d["mpd"]}, wf)
        _, rf_p = mpd.apply({"params": d["mpd"]}, jw)
        fl_s, ff_s = msd.apply({"params": d["msd"]}, wf)
        _, rf_s = msd.apply({"params": d["msd"]}, jw)
        mel = jnp.mean(jnp.abs(jax_log_mel(wf, jcfg.mel) - jax_log_mel(jw, jcfg.mel)))
        return (jh.generator_adv_loss(fl_p + fl_s) + jcfg.lambda_fm
                * jh.feature_matching_loss(rf_p + rf_s, ff_p + ff_s) + jcfg.lambda_mel * mel)

    want_dg = jax.device_get(compiled(jax.grad(d_loss), state["disc"]))
    want_gg = jax.device_get(compiled(jax.grad(g_loss), state["gen"], new["disc"]))

    tcfg = th.HiFiGANConfig(**META["generator"])
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), wav.shape)))
    tinit, tstep = th.make_vocoder_train_step(th.VocoderTrainConfig(model=tcfg),
                                              precision="highest")
    tstate = tinit("cpu", generator_state=generator_state_dict_from_jax(gen),
                   discriminator_state=discriminator_state_dicts_from_jax(dtree))
    got = tstep(tstate, torch.from_numpy(feats), torch.from_numpy(wav), torch.from_numpy(cond),
                noise=noise)
    assert tstate.step == 1
    for k in ("d_loss", "g_loss", "mel_l1", "fm", "adv"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)

    got_dg = jax_tree_from_discriminators(
        {name: {k: p.grad for k, p in m.named_parameters()}
         for name, m in (("mpd", tstate.mpd), ("msd", tstate.msd))})
    l2, leaf, err = gradient_errors(got_dg, want_dg)
    print("discriminators' gradient", l2, leaf, err)
    assert l2 <= 2e-3 and err <= 2e-3, ("discriminators' gradient", l2, leaf, err)
    sds = discriminator_state_dicts_from_jax(jax.device_get(new["disc"]))
    tmpd, tmsd = th.MultiPeriodDiscriminator(), th.MultiScaleDiscriminator()
    tmpd.load_state_dict(sds["mpd"])
    tmsd.load_state_dict(sds["msd"])
    tgen = th.Generator(tcfg)
    tgen.load_state_dict(generator_state_dict_from_jax(gen))
    loss, _ = th.generator_step_loss(th.VocoderTrainConfig(model=tcfg), tgen, tmpd, tmsd,
                                     torch.from_numpy(feats), torch.from_numpy(wav),
                                     torch.from_numpy(cond), noise)
    names = [k for k, _ in tgen.named_parameters()]
    grads = torch.autograd.grad(loss, list(tgen.parameters()))
    l2, leaf, err = gradient_errors(jax_tree_from_generator(dict(zip(names, grads))), want_gg)
    print("generator's gradient", l2, leaf, err)
    assert l2 <= 2e-3 and err <= 2e-3, ("generator's gradient", l2, leaf, err)

    lr = jcfg.lr
    for name, got_tree, want_tree, before in (
            ("gen", jax_tree_from_generator(tstate.generator.state_dict()), new["gen"], gen),
            ("disc", jax_tree_from_discriminators({"mpd": tstate.mpd.state_dict(),
                                                   "msd": tstate.msd.state_dict()}),
             new["disc"], dtree)):
        a, b, b0 = _flat(got_tree), _flat(jax.device_get(want_tree)), _flat(before)
        moved = max(float(np.abs(a[k] - b0[k]).max()) for k in b)
        assert lr * 0.9 < moved <= lr * 1.001, (name, moved)
        off = sum(int((np.abs(a[k] - b[k]) > 1e-5).sum()) for k in b)
        total = sum(v.size for v in b.values())
        print(name, "elements off by more than 1e-5:", off, "of", total)
        assert off <= 2e-3 * total, (name, off, total)
