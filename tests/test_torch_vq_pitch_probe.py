"""The port's ``vq_pitch_probe`` against the JAX package on the CPU.

At 8 training and 4 held-out utterances with 20 steps of 256 frames for
probe (f) (the script's 64, 24, 600 and 4,096), from JAX's
``quantizer_init`` state (``main(init=...)``): the r of probes (a)-(e)
within 1e-4 of the script's ``ridge`` on JAX's features and tokenizer, and
(f)'s MSE at step 20 within 1e-3 relative of the script's step (JAX's
encoder, VQ and optax Adam; the same ``RandomState(0)`` draws).
"""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np

from sylber_tpu_torch import vq_pitch_probe as vqp
from _torch_proof_helpers import FIXTURES, SCRIPTS
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

R_TOL = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_vq_probe(n_train, n_heldout, steps, batch, init):
    """The script's probes (a)-(e) and its probe-(f) step on the JAX
    package, at a reduced size: ``({key: (r_train, r_heldout)}, MSE at the
    last step)``."""
    import optax

    from sylber_tpu.flow.quantizer import (FFEncoder, quantizer_forward, unit_norm,
                                           unit_norm_sep, vq_ema_update, vq_forward)
    from sylber_tpu.io.checkpoint import load_params_npz
    from sylber_tpu.models.hubert import HubertModel
    from sylber_tpu.train.synthesis_loop import (build_synthesis_corpus, precompute_features,
                                                 synthesis_config_from_dict)
    from sylber_tpu.train.vq_synthesis import TrainedVQTokenizer, quantizer_config_from_dict

    ridge = _script("vq_pitch_probe").ridge
    meta = json.loads((FIXTURES / "mini_vq_synth.json").read_text())
    model_cfg = meta["config"]["model"]
    hubert = HubertModel(synthesis_config_from_dict(model_cfg).hubert)
    tr = build_synthesis_corpus(n_train, 5.0, seed=0)
    ho = build_synthesis_corpus(n_heldout, 5.0, seed=90001)
    # one program for both sets, unpadded: each utterance's features are its own
    feats = np.asarray(precompute_features(
        hubert, load_params_npz(str(FIXTURES / "mini_ckpt.npz")),
        np.concatenate([tr["wav"], ho["wav"]]), float(model_cfg["norm_threshold"]), 0.8,
        batch=n_train + n_heldout))
    f_tr, f_ho = feats[:n_train], feats[n_train:]
    L = min(f_tr.shape[1], tr["art"].shape[1])

    def sel(f, art):
        f, art = f[:, :L], art[:, :L]
        m = ((f ** 2).sum(-1) > 0) & (art[..., 13] > 0.02)
        return f[m], art[..., 12][m], m

    Xtr, ytr, mtr = sel(f_tr, tr["art"])
    Xho, yho, mho = sel(f_ho, ho["art"])
    qd = meta["quantizer_config"]
    qcfg = quantizer_config_from_dict(
        {k: qd[k] for k in ("output_dim", "pitch_emb_dim", "hidden_dims", "art_vq", "pitch_vq")},
        input_dim=qd["input_dim"])
    tok = TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg)
    pd = qcfg.pitch_emb_dim
    outs = [quantizer_forward(tok.state, qcfg, jnp.asarray(f[:, :L])) for f in (f_tr, f_ho)]
    pre = [np.asarray(o["non_quantized"])[m] for o, m in zip(outs, (mtr, mho))]
    q = [np.asarray(o["quantize"])[m] for o, m in zip(outs, (mtr, mho))]
    probes = {"a": ridge(Xtr, ytr, Xho, yho),
              "b": ridge(np.asarray(unit_norm(jnp.asarray(Xtr))), ytr,
                         np.asarray(unit_norm(jnp.asarray(Xho))), yho),
              "c": ridge(pre[0][:, -pd:], ytr, pre[1][:, -pd:], yho),
              "d": ridge(q[0][:, -pd:], ytr, q[1][:, -pd:], yho),
              "e": ridge(q[0][:, :-pd], ytr, q[1][:, :-pd], yho)}

    params = {"enc": init.encoder, "head": {"kernel": jnp.zeros((pd,)), "bias": jnp.zeros(())}}
    opt = optax.adam(3e-4)
    ost = opt.init(params)
    x_all = jnp.asarray(f_tr[:, :L]).reshape(-1, f_tr.shape[-1])
    y_all = jnp.asarray(tr["art"][:, :L, 12].reshape(-1))
    m_all = jnp.asarray(mtr.reshape(-1).astype(np.float32))

    @jax.jit
    def step(params, vq_state, ost, idx):  # the script's step
        x, y, m = x_all[idx], y_all[idx], m_all[idx]

        def loss_fn(p):
            t = unit_norm(x)
            t = FFEncoder.apply(p["enc"], t, len(qcfg.hidden_dims))
            t = unit_norm_sep(t, True, pd)
            pq, pidx, closs = vq_forward(vq_state, qcfg.pitch_vq, t[..., -pd:])
            pred = pq @ p["head"]["kernel"] + p["head"]["bias"]
            err = ((pred - y) ** 2 * m).sum() / jnp.maximum(m.sum(), 1.0)
            return err + closs, (err, t[..., -pd:], pidx)

        (_, (err, pre, pidx)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        up, ost = opt.update(g, ost, params)
        params = optax.apply_updates(params, up)
        return params, vq_ema_update(vq_state, qcfg.pitch_vq, pre, pidx), ost, err

    order = np.random.RandomState(0)
    pvq = init.pitch_vq
    for _ in range(steps):
        params, pvq, ost, err = step(params, pvq, ost,
                                     jnp.asarray(order.randint(0, x_all.shape[0], batch)))
    return probes, float(err)


def test_vq_pitch_probe_matches_jax(tmp_path):
    from sylber_tpu.flow.quantizer import quantizer_init
    from sylber_tpu.train.vq_synthesis import quantizer_config_from_dict

    meta = json.loads((FIXTURES / "mini_vq_synth.json").read_text())
    qd = meta["quantizer_config"]
    qcfg = quantizer_config_from_dict(
        {k: qd[k] for k in ("output_dim", "pitch_emb_dim", "hidden_dims", "art_vq", "pitch_vq")},
        input_dim=qd["input_dim"])
    init = quantizer_init(jax.random.PRNGKey(0), qcfg)
    n_train, n_heldout, steps, batch = 8, 4, 20, 256
    got = vqp.main(["--n-train", str(n_train), "--n-heldout", str(n_heldout), "--steps",
                    str(steps), "--batch", str(batch), "--device", "cpu",
                    "--out-dir", str(tmp_path)],
                   init=jax.tree_util.tree_map(np.array, init))
    assert json.loads((tmp_path / "vq_pitch_probe.json").read_text())["steps"] == steps
    probes, mse = _jax_vq_probe(n_train, n_heldout, steps, batch, init)
    for key, (r_tr, r_ho) in probes.items():
        assert abs(got["probes"][key]["r_train"] - r_tr) <= R_TOL, key
        assert abs(got["probes"][key]["r_heldout"] - r_ho) <= R_TOL, key
    assert abs(got["supervised_mse"][steps] - mse) <= 1e-3 * mse
    assert list(got["supervised_mse"]) == [steps]
