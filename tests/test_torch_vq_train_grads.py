"""``vq_ema_update`` given JAX's reseed draws (``sample_idx``): codebooks,
EMA counts and sums within 1e-6, with and without a mask, with dead codes
reseeded, at groups and quantizers > 1; the port's own draw picks only
valid points. The joint-VQ step's gradients are in
``test_torch_vq_train_joint_grads.py``: a file of its own, so that a
distributed run spreads the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.flow import quantizer as jq
from sylber_tpu_torch.flow import quantizer as tq
from test_torch_vq_train import _few_threads, _t  # noqa: E402,F401


@pytest.mark.parametrize("groups,nq,masked,dead", [(1, 1, False, False), (1, 1, True, True),
                                                   (2, 3, True, True), (2, 2, False, True)])
def test_vq_ema_update_matches_jax(groups, nq, masked, dead):
    cfg = dict(dim=8, groups=groups, num_quantizers=nq, codebook_size=16,
               dead_threshold=1.0 if dead else 0.0)
    jcfg, tcfg = jq.GroupedResidualVQConfig(**cfg), tq.GroupedResidualVQConfig(**cfg)
    state = jq.vq_init(jax.random.PRNGKey(groups + nq), jcfg)
    if dead:  # counts below the threshold for half the codes
        state = state._replace(cluster_sizes=state.cluster_sizes.at[..., ::2].set(0.5))
    rng = np.random.RandomState(groups * 10 + nq)
    x = rng.randn(3, 20, 8).astype(np.float32)
    mask = rng.rand(3, 20) > 0.3 if masked else None
    idx = np.asarray(jq.vq_encode(state, jcfg, jnp.asarray(x)))
    key = jax.random.PRNGKey(5)
    want = jq.vq_ema_update(state, jcfg, jnp.asarray(x), jnp.asarray(idx), rng=key,
                            mask=None if mask is None else jnp.asarray(mask))
    m = np.ones(60, np.float32) if mask is None else mask.reshape(-1).astype(np.float32)
    logits = jnp.where(jnp.asarray(m) > 0, 0.0, -1e9)
    sample_idx = jax.random.categorical(key, logits, shape=(groups, nq, 16))
    got = tq.vq_ema_update(tq.VQState(*(_t(a) for a in state)), tcfg, torch.from_numpy(x),
                           _t(idx), mask=None if mask is None
                           else torch.from_numpy(mask), sample_idx=_t(sample_idx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if dead:
        assert (np.asarray(want.cluster_sizes) == 2.0).any()  # codes were reseeded
    # the port's own draw: only valid points
    draw = tq.vq_reseed_draw(torch.Generator().manual_seed(0), torch.from_numpy(m), (4, 50))
    assert (m[draw.numpy()] > 0).all()
