"""``vq_ema_update`` given JAX's reseed draws (``sample_idx``): codebooks,
EMA counts and sums within 1e-6, with and without a mask, with dead codes
reseeded, at groups and quantizers > 1; the port's own draw picks only
valid points.

Every gradient leaf of the port's joint-VQ step (``train/vq_synthesis.py``)
against JAX's: the step's clipped gradient (quantizer encoder, input MLP,
regressor, pitch head) within 1e-4 of the largest, against the gradient of
``sylber_tpu/train/vq_synthesis.py``'s loss rebuilt from its public parts
(``quantizer_forward``, the input MLP, ``cfm_loss``, the pitch head), taken
op by op and clipped by optax's ``clip_by_global_norm(0.5)``. The setting is
``test_torch_vq_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sylber_tpu.flow import quantizer as jq
from sylber_tpu.flow.cfm import cfm_loss as jax_cfm_loss
from sylber_tpu_torch.flow import quantizer as tq
from sylber_tpu_torch.io.checkpoint import tree_from_state_dict
from test_torch_synthesis_train import batch_of, worst_leaf  # noqa: E402
from test_torch_vq_train import HEAD, _few_threads, _t, mini_vq, port_step  # noqa: E402,F401


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


def test_joint_vq_gradients_match_jax(mini_vq):  # noqa: F811
    jsynth, port, (qcfg_j, jqs), (qcfg_t, _), tcfg = mini_vq
    pitch_w, commit_w = float(tcfg["pitch_loss_weight"]), float(tcfg["commit_weight"])
    batch = batch_of(seed=3)
    rng = jax.random.PRNGKey(4)
    pstate, _, _ = port_step(mini_vq, batch, rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, km = jax.random.split(rng)
    trainable = {"qenc": jqs.encoder, "input_mlp": jsynth.params.input_mlp,
                 "regressor": jsynth.params.regressor,
                 "pitch_head": {k: jnp.asarray(v) for k, v in HEAD.items()}}
    c = jsynth.config
    non_blank = jb["features"] ** 2
    non_blank = non_blank.sum(-1) > 0

    def jloss(t):
        out = jq.quantizer_forward(jq.QuantizerState(t["qenc"], jqs.art_vq, jqs.pitch_vq),
                                   qcfg_j, jb["features"])
        q = jnp.where(non_blank[..., None], out["quantize"], 0.0)
        cond = jnp.where(non_blank[..., None],
                         jsynth.input_mlp.apply({"params": t["input_mlp"]}, q), 0.0)
        art = jb["art"].at[..., 12].multiply(c.pitch_amp)

        def apply_fn(w, times, x1, cond_emb, mask, cond_mask, kd, is_train):
            return jsynth.regressor.apply({"params": t["regressor"]}, w, times, cond=x1,
                                          cond_emb=cond_emb, self_attn_mask=mask,
                                          cond_mask=cond_mask)

        cfm = jax_cfm_loss(apply_fn, km, art, cond_emb=cond)
        pred = out["quantize"][..., -8:] @ t["pitch_head"]["kernel"] + t["pitch_head"]["bias"]
        pmask = (non_blank & (jb["art"][..., 13] > 0.02)).astype(jnp.float32)
        perr = (pred - jb["art"][..., 12] * c.pitch_amp) ** 2
        pl = (perr * pmask).sum() / jnp.maximum(pmask.sum(), 1.0)
        return cfm + commit_w * out["commitment_loss"] + pitch_w * pl

    with jax.disable_jit():
        want_grads = jax.grad(jloss)(trainable)
    # the step leaves the clipped gradient (optax's clip_by_global_norm, 0.5) in .grad
    want_grads = jax.device_get(jax.tree.map(
        lambda g: g * jnp.minimum(1.0, 0.5 / optax.global_norm(want_grads)), want_grads))
    n_enc = 3 * len(qcfg_t.hidden_dims) + 1
    grads = [p.grad for p in pstate.params]
    got_grads = {
        "qenc": {str(i): {"kernel": grads[2 * i].numpy(), "bias": grads[2 * i + 1].numpy()}
                 for i in range(n_enc)},
        "input_mlp": tree_from_state_dict({k: p.grad for k, p in port.input_mlp.named_parameters()}),
        "regressor": tree_from_state_dict({k: p.grad for k, p in port.regressor.named_parameters()}),
        "pitch_head": {"kernel": grads[-2].numpy(), "bias": grads[-1].numpy()}}
    want_grads = dict(want_grads, qenc={str(i): l for i, l in enumerate(want_grads["qenc"])})
    leaf, err = worst_leaf(got_grads, want_grads)
    assert err <= 1e-4, (leaf, err)
