"""``DistillConfig.ema_fp32_shadow``: the EMA teacher's dtype.

JAX's rule (``sylber_tpu/train/distill.py``, ``ema.py``): with
``ema_decay < 1`` the teacher is a float32 shadow of the student when
``ema_fp32_shadow`` (the default), else a copy in the student's dtypes. On
bf16 leaves, the port's ``ema_init`` / ``ema_update`` without the shadow
stay bf16 and equal JAX's over 3 updates bit for bit (the same bf16
arithmetic: a product and a sum, each rounded to bf16). Both packages keep
float32 parameters (flax's ``param_dtype``), so for a training state the
flag keeps the teacher float32 either way, as in JAX; the port's
``init_train_state`` builds the teacher from ``ema_init``'s leaves in their
dtypes, and a checkpoint round trip keeps them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.train import distill as jax_distill
from sylber_tpu.train import ema as jax_ema
from sylber_tpu_torch.io.checkpoint import TrainCheckpointManager
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.train import distill
from sylber_tpu_torch.train import ema as port_ema

TINY = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64, conv_dim=(16,) * 7,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_hidden_layers=1)


def test_ema_without_the_shadow_keeps_bf16_leaves_as_jax():
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(8, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    j_ema = jax_ema.ema_init({k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
                             fp32_shadow=False)
    p_ema = port_ema.ema_init({k: torch.from_numpy(v).to(torch.bfloat16)
                               for k, v in params.items()}, fp32_shadow=False)
    assert all(v.dtype == torch.bfloat16 for v in p_ema.values())
    for i in range(3):
        new = {k: (v + 0.1 * (i + 1)).astype(np.float32) for k, v in params.items()}
        j_ema = jax_ema.ema_update(j_ema, {k: jnp.asarray(v, jnp.bfloat16)
                                           for k, v in new.items()}, 0.9)
        port_ema.ema_update(p_ema, {k: torch.from_numpy(v).to(torch.bfloat16)
                                    for k, v in new.items()}, 0.9)
        for k in params:
            assert j_ema[k].dtype == jnp.bfloat16 and p_ema[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(p_ema[k].float().numpy(),
                                          np.asarray(j_ema[k], np.float32))


def test_training_state_teacher_dtype_follows_jax_and_survives_a_checkpoint(tmp_path):
    """Shadow off at ``ema_decay`` 0.9: the teacher keeps the student's
    float32, as JAX's ``ema_params`` do; 3 steps move it as with the shadow
    on (the same float32 arithmetic), and a save / restore keeps its dtype
    and values."""
    base = distill.DistillConfig(model=HubertConfig(precision="default", **TINY),
                                 ema_decay=0.9, lr=1e-3, warmup_steps=2)
    jcfg = jax_distill.DistillConfig(model=jax_hubert.HubertConfig(**TINY), ema_decay=0.9,
                                     ema_fp32_shadow=False)
    jparams = jax.jit(jax_hubert.HubertModel(jcfg.model).init_params, static_argnums=1)(
        jax.random.PRNGKey(0), 4000)
    jstate = jax_distill.init_train_state(jcfg, jax.random.PRNGKey(0), params=jparams)
    assert {x.dtype for x in jax.tree.leaves(jstate.ema_params)} == {jnp.dtype("float32")}

    rng = np.random.RandomState(0)
    batch = {"input_values": torch.from_numpy(rng.randn(2, 4000).astype(np.float32)),
             "attention_mask": torch.ones(2, 4000, dtype=torch.int32),
             "segments": torch.tensor([[[0, 5], [5, 12]]] * 2, dtype=torch.int32),
             "num_segments": torch.tensor([2, 2], dtype=torch.int32), "noise": None}
    teachers = {}
    for shadow in (True, False):
        cfg = dataclasses.replace(base, ema_fp32_shadow=shadow)
        state = distill.init_train_state(cfg, "cpu", seed=0)
        assert all(v.dtype == torch.float32 for v in state.ema.values())
        step = distill.make_train_step(cfg)
        for _ in range(3):
            step(state, batch, 0)
        teachers[shadow] = state
    a, b = teachers[True].ema, teachers[False].ema
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(b[k], teachers[False].student.state_dict()[k]) for k in b)

    mgr = TrainCheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(3, teachers[False].state_dict())
    fresh = distill.init_train_state(dataclasses.replace(base, ema_fp32_shadow=False), "cpu",
                                     seed=1)
    fresh.load_state_dict(mgr.restore())
    assert fresh.step == 3
    for k, v in fresh.ema.items():
        assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
