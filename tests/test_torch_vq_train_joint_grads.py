"""Every gradient leaf of the port's joint-VQ step (``train/vq_synthesis.py``)
against JAX's: the step's clipped gradient (quantizer encoder, input MLP,
regressor, pitch head) within 1e-4 of the largest, against the gradient of
``sylber_tpu/train/vq_synthesis.py``'s loss rebuilt from its public parts
(``quantizer_forward``, the input MLP, ``cfm_loss``, the pitch head), taken
op by op and clipped by optax's ``clip_by_global_norm(0.5)``. The setting is
``test_torch_vq_train.py``'s.
"""

import jax
import jax.numpy as jnp
import optax

from sylber_tpu.flow import quantizer as jq
from sylber_tpu.flow.cfm import cfm_loss as jax_cfm_loss
from sylber_tpu_torch.io.checkpoint import tree_from_state_dict
from test_torch_synthesis_train import batch_of, worst_leaf  # noqa: E402
from test_torch_vq_train import HEAD, _few_threads, mini_vq, port_step  # noqa: E402,F401


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
