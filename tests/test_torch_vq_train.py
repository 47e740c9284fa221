"""The port's joint-VQ training half (``flow/quantizer.py::vq_ema_update``,
``train/vq_synthesis.py``) against ``sylber_tpu`` on the CPU, fp32.

- One joint-VQ step from ``mini_vq_synth.npz`` + ``mini_vq_tokenizer.npz``
  with JAX's draws, the input MLP's dropout at 0 (JAX op by op, as in
  ``test_torch_synthesis_train.py``): the losses within rtol 1e-5, the
  gradient norm within 1e-4, and after the step the parameters within 1e-6
  and both VQs' EMA state within 1e-6 (every gradient leaf, and
  ``vq_ema_update`` alone: ``test_torch_vq_train_grads.py``).
- The trained quantizer loads into the JAX tokenizer through ``save_npz``.
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
from sylber_tpu.train import vq_synthesis as jvq
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_config
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.io.checkpoint import tree_from_state_dict
from sylber_tpu_torch.train import vq_synthesis as tvq
from sylber_tpu_torch.vq_tokenizer import TrainedVQTokenizer
from test_torch_synthesis_train import _few_threads, batch_of, flat, jax_draws  # noqa: E402,F401

FIXTURES = Path(__file__).parent / "fixtures"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def mini_vq():
    meta = json.loads((FIXTURES / "mini_vq_synth.json").read_text())
    mc = meta["config"]["model"]
    trained = load_params_npz(str(FIXTURES / "mini_vq_synth.npz"))
    enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
    jc = dataclasses.replace(jax_config(mc), input_dropout=0.0)
    pc = dataclasses.replace(tsyn.synthesis_config_from_dict(mc), input_dropout=0.0)
    pc = dataclasses.replace(pc, regressor=dataclasses.replace(pc.regressor, precision="highest"))
    qcfg_j = jvq.quantizer_config_from_dict(mc["quantizer_configs"], input_dim=144)
    qcfg_t = tvq.quantizer_config_from_dict(mc["quantizer_configs"], input_dim=144)
    jtok = jvq.TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg_j)
    ttok = TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg_t,
                                       device="cpu")
    jsynth = jsyn.SegmentSynthesis(config=jc, params=jsyn.SynthesisParams(
        enc, trained["input_mlp"], trained["regressor"]))
    port = tsyn.SegmentSynthesis(config=pc, params={"hubert": enc, **trained}, device="cpu")
    return jsynth, port, (qcfg_j, jtok.state), (qcfg_t, ttok.state), meta["config"]["train"]


KW = dict(lr=4e-4, warmup_steps=0, total_steps=100, min_factor=0.05)
HEAD = {"kernel": np.random.RandomState(0).randn(8).astype(np.float32) * 0.1,
        "bias": np.float32(0.05)}  # not zero, so that its gradient reaches the codes


def port_step(mini_vq, batch, rng):
    """The port's state and one step on ``batch`` with the draws JAX's step
    makes from ``rng``: ``(state, metrics, parameters before)``."""
    _, port, (qcfg_j, _), (qcfg_t, tqs), tcfg = mini_vq
    _, km = jax.random.split(rng)
    k_art, k_pitch = jax.random.split(jax.random.fold_in(rng, 1))
    m = (batch["features"] ** 2).sum(-1).reshape(-1) > 0
    logits = jnp.where(jnp.asarray(m), 0.0, -1e9)
    sample_idx = tuple(_t(jax.random.categorical(k, logits, shape=(1, 1, c.codebook_size)))
                       for k, c in ((k_art, qcfg_j.art_vq), (k_pitch, qcfg_j.pitch_vq)))
    popt = tsyn.make_synthesis_optimizer(**KW)
    pstate = tvq.init_vq_synthesis_train_state(port, qcfg_t, popt, quantizer=tqs)
    with torch.no_grad():
        for k, v in HEAD.items():
            pstate.pitch_head[k].copy_(torch.tensor(v))
    pstep = tvq.make_vq_synthesis_train_step(port, qcfg_t, popt,
                                             commit_weight=float(tcfg["commit_weight"]),
                                             pitch_weight=float(tcfg["pitch_loss_weight"]))
    before = [p.detach().clone() for p in pstate.params]
    pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0,
               draws=jax_draws(km, batch["art"].shape), sample_idx=sample_idx)
    return pstate, pm, before


def test_joint_vq_step_matches_jax(mini_vq, tmp_path):
    jsynth, port, (qcfg_j, jqs), (qcfg_t, tqs), tcfg = mini_vq
    jopt = jsyn.make_synthesis_optimizer(**KW)
    head = {k: jnp.asarray(v) for k, v in HEAD.items()}
    trainable = {"qenc": jqs.encoder, "input_mlp": jsynth.params.input_mlp,
                 "regressor": jsynth.params.regressor, "pitch_head": head}
    jstate = jvq.VQSynthState(jnp.zeros((), jnp.int32), jqs, jsynth.params.input_mlp,
                              jsynth.params.regressor, head, jopt.init(trainable))
    jstep = jvq.make_vq_synthesis_train_step(jsynth, qcfg_j, jopt,
                                             commit_weight=float(tcfg["commit_weight"]),
                                             pitch_weight=float(tcfg["pitch_loss_weight"]))
    batch = batch_of(seed=3)
    rng = jax.random.PRNGKey(4)
    with jax.disable_jit():
        jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    pstate, pm, before = port_step(mini_vq, batch, rng)
    n_enc = 3 * len(qcfg_t.hidden_dims) + 1
    for k in ("loss", "cfm_loss", "commit_loss", "pitch_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)

    # the parameters after the step, and the codebooks' EMA state
    new_t = {"qenc": {str(i): {k: pstate.quantizer.encoder[i][k].detach().numpy()
                               for k in ("kernel", "bias")} for i in range(n_enc)},
             "input_mlp": tree_from_state_dict(port.input_mlp.state_dict()),
             "regressor": tree_from_state_dict(port.regressor.state_dict()),
             "pitch_head": {k: v.detach().numpy() for k, v in pstate.pitch_head.items()}}
    want_t = {"qenc": {str(i): l for i, l in enumerate(jax.device_get(jnew.quantizer.encoder))},
              "input_mlp": jax.device_get(jnew.input_mlp),
              "regressor": jax.device_get(jnew.regressor),
              "pitch_head": jax.device_get(jnew.pitch_head)}
    g, w = flat(new_t), flat(want_t)
    assert float(np.abs(before[0].numpy() - w["qenc/0/kernel"]).max()) > 1e-4  # it moved
    assert max(float(np.abs(g[k] - w[k]).max()) for k in w) <= 1e-6
    for vq_got, vq_want in ((pstate.quantizer.art_vq, jnew.quantizer.art_vq),
                            (pstate.quantizer.pitch_vq, jnew.quantizer.pitch_vq)):
        for a, b in zip(vq_got, vq_want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert pstate.step == 1 and not port.regressor.training

    # the trained quantizer as the JAX tokenizer reads it
    tvq.tokenizer_of(pstate, qcfg_t).save_npz(str(tmp_path / "tok.npz"))
    back = jvq.TrainedVQTokenizer.load_npz(str(tmp_path / "tok.npz"), qcfg_j)
    np.testing.assert_array_equal(np.asarray(back.state.art_vq.codebooks),
                                  pstate.quantizer.art_vq.codebooks.numpy())
