"""The trainer's parts against the JAX package, on seeded numpy inputs.

The learning-rate schedule, the thresholder, the EMA update, the int16 PCM
normalisation, the span mask and the noise mixer of ``sylber_tpu_torch``
against ``sylber_tpu``'s; where the JAX function draws random numbers, the
test draws them with ``jax.random`` from the same key split and hands them
to the port's pure apply function. The optimizer (clip, AdamW, MultiSteps)
against the optax chain over three updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sylber_tpu.data import noise as jax_noise
from sylber_tpu.train import distill as jax_distill
from sylber_tpu.train import ema as jax_ema
from sylber_tpu.train import lr as jax_lr
from sylber_tpu.train import thresholder as jax_thr
from sylber_tpu_torch.data import noise as port_noise
from sylber_tpu_torch.data.device import pcm_normalize
from sylber_tpu_torch.train import distill as port_distill
from sylber_tpu_torch.train import ema as port_ema
from sylber_tpu_torch.train import lr as port_lr
from sylber_tpu_torch.train import thresholder as port_thr


@pytest.mark.parametrize("warmup,total,min_factor,hold", [
    (5, 30, 0.05, 0), (5, 30, 1.0, 0), (0, 20, 0.2, 4), (3, 10, 0.05, 6)])
def test_schedule_matches_jax(warmup, total, min_factor, hold):
    want = jax_lr.cosine_warmup_schedule(1e-3, warmup, total, min_factor, hold)
    got = port_lr.cosine_warmup_schedule(1e-3, warmup, total, min_factor, hold)
    steps = range(warmup + hold + total + 5)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6, atol=0)


def _thr_pair(**kw):
    return jax_thr.thresholder_init(**kw), port_thr.thresholder_init(**kw)


def _close(port_state, jax_state, rtol=1e-6):
    for a, b in zip(port_state, jax_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("thrupdate", [True, False])
def test_thresholder_matches_jax_in_both_stage2_modes(thrupdate):
    """The teacher-side update of the stage-2 step (signal only with
    ``use_train_thrupdate``, else signal and noise), then the student-side
    noise update, and the threshold after each, for a few steps."""
    rng = np.random.RandomState(0)
    js, ps = _thr_pair()
    for _ in range(4):
        norms = np.abs(rng.randn(2 * 300) * 4 + 3).astype(np.float32)
        student = np.abs(rng.randn(2 * 300) * 2).astype(np.float32)
        jt, pt = jax_thr.get_threshold(js), port_thr.get_threshold(ps)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6)
        jm, pm = jnp.asarray(norms) >= jt, torch.from_numpy(norms) >= pt
        assert np.array_equal(pm.numpy(), np.asarray(jm))
        if thrupdate:
            js = jax_thr.update_stats(js, signal=jnp.asarray(norms), signal_mask=jm, decay=0.99)
            ps = port_thr.update_stats(ps, signal=torch.from_numpy(norms), signal_mask=pm,
                                       decay=0.99)
            js = jax_thr.update_stats(js, noise=jnp.asarray(student), noise_mask=~jm, decay=0.99)
            ps = port_thr.update_stats(ps, noise=torch.from_numpy(student), noise_mask=~pm,
                                       decay=0.99)
        else:
            js = jax_thr.update_stats(js, signal=jnp.asarray(norms), signal_mask=jm,
                                      noise=jnp.asarray(norms), noise_mask=~jm, decay=0.99)
            ps = port_thr.update_stats(ps, signal=torch.from_numpy(norms), signal_mask=pm,
                                       noise=torch.from_numpy(norms), noise_mask=~pm,
                                       decay=0.99)
        _close(ps, js)
    assert not np.isclose(float(ps.signal_mean), 6.10)  # the stats moved


def test_thresholder_fixed_and_empty_selection_match_jax():
    js, ps = _thr_pair(threshold=3.0)
    x = np.linspace(0, 8, 50).astype(np.float32)
    js = jax_thr.update_stats(js, signal=jnp.asarray(x), decay=0.5)
    ps = port_thr.update_stats(ps, signal=torch.from_numpy(x), decay=0.5)
    _close(ps, js)
    assert float(port_thr.get_threshold(ps)) == 3.0
    js, ps = _thr_pair()
    none = np.zeros(50, bool)
    js = jax_thr.update_stats(js, noise=jnp.asarray(x), noise_mask=jnp.asarray(none))
    ps = port_thr.update_stats(ps, noise=torch.from_numpy(x), noise_mask=torch.from_numpy(none))
    _close(ps, js)


def test_ema_update_with_fp32_shadow_matches_jax():
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(8, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    bf16 = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    j_ema = jax_ema.ema_init(jax.tree.map(jnp.asarray, bf16), fp32_shadow=True)
    p_params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    p_ema = port_ema.ema_init(p_params, fp32_shadow=True)
    assert all(v.dtype == torch.float32 for v in p_ema.values())
    for i in range(3):
        new = {k: (v + 0.1 * (i + 1)).astype(np.float32) for k, v in params.items()}
        j_ema = jax_ema.ema_update(j_ema, {k: jnp.asarray(v, jnp.bfloat16) for k, v in new.items()},
                                   0.999)
        port_ema.ema_update(p_ema, {k: torch.from_numpy(v).to(torch.bfloat16)
                                    for k, v in new.items()}, 0.999)
        for k in params:
            np.testing.assert_allclose(p_ema[k].numpy(), np.asarray(j_ema[k]), rtol=1e-6)
    back = port_ema.ema_restore(p_ema, p_params)
    assert all(v.dtype == torch.bfloat16 for v in back.values())


def test_pcm_normalize_matches_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 700) * 3000).clip(-32767, 32767).astype(np.int16)
    mask = np.ones((3, 700), np.int32)
    mask[1, 400:] = 0
    mask[2, :] = 0  # nothing attended
    want = np.asarray(jax_distill._pcm_normalize(jnp.asarray(x), jnp.asarray(mask)))
    got = pcm_normalize(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = np.asarray(jax_distill._pcm_normalize(jnp.asarray(x), None))
    got = pcm_normalize(torch.from_numpy(x), None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _segments(rng, B, MS, T):
    segs = np.zeros((B, MS, 2), np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        t, k = int(rng.randint(0, 3)), 0
        while t < T - 2 and k < MS:
            e = min(T, t + int(rng.randint(2, 9)))
            segs[b, k] = (t, e)
            t, k = e + int(rng.randint(0, 3)), k + 1
        n[b] = k if b != 1 else 0  # item 1 has no segments
    return segs, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_mask_bit_exact_given_jax_draws(seed):
    cfg_j = jax_distill.DistillConfig(mask_prob=0.3, min_mask_n=2, max_mask_set=3)
    cfg_p = port_distill.DistillConfig(mask_prob=0.3, min_mask_n=2, max_mask_set=3)
    B, T = 5, 60
    MS = T + 1
    segs, n = _segments(np.random.RandomState(seed), B, MS, T)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_distill._span_mask(key, jnp.asarray(segs), jnp.asarray(n), T, cfg_j))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"bern": jax.random.uniform(k1, (B, MS)), "anchor": jax.random.uniform(k2, (B, MS)),
             "span": jax.random.randint(k3, (B, MS), 1, cfg_j.max_mask_set + 1)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    got = port_distill.span_mask_apply(draws, torch.from_numpy(segs), torch.from_numpy(n), T,
                                       cfg_p).numpy()
    assert want.any() and np.array_equal(got, want)
    # the port's own draws give a mask of the same kind
    own = port_distill._span_mask(torch.Generator().manual_seed(seed), torch.from_numpy(segs),
                                  torch.from_numpy(n), T, cfg_p)
    assert own.shape == (B, T) and own.dtype == torch.bool and not own[1].any()


@pytest.mark.parametrize("seed", [0, 3])
def test_mix_noise_matches_jax_given_the_same_draws(seed):
    cfg = dict(augment_prob=0.7, utterance_mix_ratio=0.5, shift_range=(0.0, 0.7),
               magnitude_range=(0.05, 0.7), utterance_magnitude_max_scale=0.2)
    rng = np.random.RandomState(seed)
    B, L = 8, 500
    wav, noise = rng.randn(B, L).astype(np.float32), rng.randn(B, L).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_noise.mix_noise(key, jnp.asarray(wav), jnp.asarray(noise),
                                          jax_noise.NoiseMixerConfig(**cfg)))
    k = jax.random.split(key, 7)
    u = {name: jax.random.uniform(k[i], (B,)) for i, name in enumerate(port_noise.DRAWS)
         if name != "perm"}
    u["perm"] = jax.random.permutation(k[2], B)
    draws = {name: torch.from_numpy(np.array(v)) for name, v in u.items()}
    got = port_noise.mix_noise_apply(torch.from_numpy(wav), torch.from_numpy(noise), draws,
                                     port_noise.NoiseMixerConfig(**cfg)).numpy()
    assert not np.array_equal(got, wav)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,warmup", [(1, 0), (1, 2), (2, 0)])
def test_optimizer_matches_the_optax_chain(k, warmup):
    """Three updates (k micro-batches each) of a small parameter tree: clip by
    the global norm (one step's gradient is above 0.5, so it is clipped),
    AdamW at the warmup-cosine rate, MultiSteps accumulation."""
    kw = dict(lr=1e-2, warmup_steps=warmup, total_steps=50, min_factor=0.05,
              accumulate_grad_batches=k)
    jcfg, pcfg = jax_distill.DistillConfig(**kw), port_distill.DistillConfig(**kw)
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(6, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    tx = jax_distill.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    pp = [torch.from_numpy(params[n].copy()) for n in ("b", "w")]  # optax's key order
    opt = port_distill.make_optimizer(pcfg, pp)
    acc = [torch.zeros_like(p) for p in pp] if k > 1 else None
    schedule = port_lr.cosine_warmup_schedule(1e-2, warmup, 50, 0.05, 0)
    clipped = 0
    for step in range(3 * k):
        scale = 2.0 if step == 1 else 0.05
        g = {n: (rng.randn(*v.shape) * scale).astype(np.float32) for n, v in params.items()}
        clipped += optax.global_norm(g) > 0.5
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        port_distill.apply_gradients(pp, [torch.from_numpy(g[n]) for n in ("b", "w")], opt, acc,
                                     step, pcfg, schedule)
        for p, n in zip(pp, ("b", "w")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=1e-6)
    assert clipped >= 1
    assert not np.allclose(pp[1].numpy(), params["w"])
