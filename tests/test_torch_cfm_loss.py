"""The port's CFM loss (``sylber_tpu_torch/flow/cfm.py``) against
``sylber_tpu/flow/cfm.py`` on the CPU, fp32.

- ``mask_from_frac_lengths`` equals JAX's bit for bit given JAX's two
  uniforms, at lengths where ``start + lengths`` has a fraction (the end is
  compared as a float).
- ``cfm_loss`` within rtol 1e-6 given JAX's x0, times and span (the test
  derives them by JAX's own ``split(rng, 4)``), on a closed-form field and
  with a padding mask.
- The regressor in train mode under autograd takes ``attention_xla``: a
  kernel entry that must not be called is monkeypatched in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.flow import cfm as jcfm
from sylber_tpu_torch.flow import cfm as tcfm
from sylber_tpu_torch.models import voicebox as tvb
from sylber_tpu_torch.ops import attention as tattn
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def jax_draws(rng, shape):
    """The draws ``cfm_loss`` makes from ``rng``, as the port's CFMDraws."""
    B = shape[0]
    k0, kt, km, _ = jax.random.split(rng, 4)
    k1, k2 = jax.random.split(km)
    x0 = jax.random.normal(k0, shape, jnp.float32)
    times = jax.random.uniform(kt, (B,), jnp.float32)
    u1, u2 = jax.random.uniform(k1, (B,)), jax.random.uniform(k2, (B,))
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tcfm.CFMDraws(as_t(x0), as_t(times), as_t(u1), as_t(u2), 0)


@pytest.mark.parametrize("L,frac_range", [(250, (0.7, 1.0)), (37, (0.7, 1.0)), (101, (0.1, 0.5)),
                                          (1, (0.7, 1.0))])
def test_mask_from_frac_lengths_is_jax_bit_for_bit(L, frac_range):
    fractional = 0
    for seed in range(8):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(jcfm.mask_from_frac_lengths(rng, 16, L, frac_range))
        k1, k2 = jax.random.split(rng)
        u1, u2 = jax.random.uniform(k1, (16,)), jax.random.uniform(k2, (16,))
        got = tcfm.mask_from_frac_lengths(torch.from_numpy(np.array(u1)),
                                          torch.from_numpy(np.array(u2)), L, frac_range)
        np.testing.assert_array_equal(got.numpy(), want)
        lengths = (np.asarray(u1) * np.float32(frac_range[1] - frac_range[0])
                   + np.float32(frac_range[0])) * np.float32(L)
        start = np.maximum((L - lengths.astype(np.int32)) * np.asarray(u2), 0.0)
        fractional += int(np.sum(start % 1 > 0))
    if L > 1:
        assert fractional > 0  # the float end is exercised


def test_draws_have_their_shapes_and_seeded_values():
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    a = tcfm.cfm_draws((3, 20, 14), *gens, device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    b = tcfm.cfm_draws((3, 20, 14), *gens, device="cpu")
    assert a.x0.shape == (3, 20, 14) and a.times.shape == a.frac_u.shape == (3,)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a.dropout_seed == b.dropout_seed
    assert 0 <= float(a.times.min()) and float(a.times.max()) < 1


@pytest.mark.parametrize("sigma,masked", [(0.0, False), (0.0, True), (0.1, True)])
def test_cfm_loss_matches_jax(sigma, masked):
    rng = np.random.RandomState(5)
    B, L, D = 4, 60, 14
    x1 = rng.randn(B, L, D).astype(np.float32)
    emb = rng.randn(B, L, 8).astype(np.float32)
    weight = rng.randn(D, D).astype(np.float32) * 0.3
    mask = None
    if masked:
        mask = (np.arange(L)[None] < np.array([60, 41, 7, 0])[:, None]).astype(np.float32)

    def jax_apply(w, times, cond, cond_emb, m, cond_mask, kd, train):
        c = cond * (~cond_mask)[..., None]
        return (w @ weight + times[:, None, None] * c
                + cond_emb[..., :1] * 0.1)

    def port_apply(w, times, cond, cond_emb, m, cond_mask, seed, train):
        c = cond * (~cond_mask)[..., None]
        return w @ torch.from_numpy(weight) + times[:, None, None] * c + cond_emb[..., :1] * 0.1

    key = jax.random.PRNGKey(11)
    want = jcfm.cfm_loss(jax_apply, key, jnp.asarray(x1), cond_emb=jnp.asarray(emb),
                         mask=None if mask is None else jnp.asarray(mask), sigma=sigma)
    got = tcfm.cfm_loss(port_apply, jax_draws(key, x1.shape), torch.from_numpy(x1),
                        cond_emb=torch.from_numpy(emb),
                        mask=None if mask is None else torch.from_numpy(mask), sigma=sigma)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_mode_regressor_takes_the_differentiable_core(monkeypatch):
    def kernel(*a, **k):
        raise AssertionError("the forward-only attention core was called under autograd")

    monkeypatch.setattr(tvb, "attention", kernel)
    called = []
    real = tattn.attention_xla

    def xla(*a, **k):
        called.append(k.get("scale"))
        return real(*a, **k)

    monkeypatch.setattr(tvb, "attention_xla", xla)
    cfg = tvb.RegressorConfig(depth=2, dim=32, heads=2, dim_head=16, dim_in_proj=8,
                              dim_cond_emb=8, ff_dropout=0.1)
    reg = tvb.init_regressor(tvb.Regressor(cfg), torch.Generator().manual_seed(0))
    reg.train()
    x = torch.randn(2, 10, 14)
    out = reg(x, torch.rand(2), cond=x, cond_emb=torch.randn(2, 10, 8),
              dropout=tattn.Dropout(3, "cpu"))
    out.square().mean().backward()
    assert called == [10.0, 10.0]
    qkv = reg.transformer.attn_0.to_qkv.weight.grad
    assert qkv is not None and float(qkv.abs().max()) > 0
    # dropout is on in train mode with a source, off in eval mode
    again = reg(x, torch.rand(2), cond=x, cond_emb=torch.zeros(2, 10, 8),
                dropout=tattn.Dropout(4, "cpu"))
    reg.eval()
    monkeypatch.setattr(tvb, "attention", tattn.attention)  # eval without autograd: the kernel
    with torch.no_grad():
        emb = torch.randn(2, 10, 8)
        a = reg(x, 0.5, cond=x, cond_emb=emb, dropout=tattn.Dropout(3, "cpu"))
        b = reg(x, 0.5, cond=x, cond_emb=emb, dropout=tattn.Dropout(4, "cpu"))
    assert torch.equal(a, b) and again.shape == a.shape


def test_attn_dropout_is_declared_and_never_applied():
    """As in JAX's regressor: only ``ff_dropout`` draws masks in train mode."""
    cfg = tvb.RegressorConfig(depth=2, dim=32, heads=2, dim_head=16, dim_in_proj=8,
                              dim_cond_emb=8, attn_dropout=0.5, ff_dropout=0.0)
    reg = tvb.init_regressor(tvb.Regressor(cfg), torch.Generator().manual_seed(0)).train()
    x, emb = torch.randn(2, 10, 14), torch.randn(2, 10, 8)
    a = reg(x, torch.full((2,), 0.5), cond=x, cond_emb=emb, dropout=tattn.Dropout(3, "cpu"))
    b = reg(x, torch.full((2,), 0.5), cond=x, cond_emb=emb, dropout=tattn.Dropout(4, "cpu"))
    assert torch.equal(a, b)
