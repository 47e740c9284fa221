"""One training step of the port against ``sylber_tpu.train.distill``.

Weights: the first two encoder layers of the trained ``mini_ckpt.npz``,
carried across by the weight bridge; fp32 at ``highest`` precision, every
dropout 0, no warmup, an empty merge-threshold range (so nothing in the
step is random). Stage 1 takes the synthetic corpus's true segments; stage
2 segments the teacher's states online, with and without
``use_train_thrupdate``. Tolerances: loss and grad_norm rtol 1e-5; each
gradient leaf within 1e-5 * max(1, max |g|); segments and their count
exact; thresholder rtol 1e-5; parameters after three steps at lr 1e-3
atol 1e-5. Then the port's own dropout and remat: seeded, deterministic
in eval mode, the kept fraction within 4 sigma of 1 - p, and remat equal
to no remat with dropout on. (The stage-2 cases are in
``test_torch_distill_stage2.py`` and ``test_torch_distill_stage2_steps.py``,
the bf16 path in ``test_torch_distill_bf16.py``, so that each file stays
short.)
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.data.dataset import SyntheticSpeechDataset
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.ops import segment as jax_segment
from sylber_tpu.train import distill as jax_distill
from sylber_tpu.train.thresholder import get_threshold
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert
from sylber_tpu_torch.ops import segment as port_segment
from sylber_tpu_torch.train import distill as port_distill

FIXTURES = Path(__file__).parent / "fixtures"
LAYERS = 2
THR = dict(signal_mean=6.10, signal_var=0.87, noise_mean=0.34, noise_var=0.34)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the models here are tiny, and the test workers
    share the machine's cores (more threads only contend)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _hub():
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    return dict(hub, num_hidden_layers=LAYERS, precision="highest", hidden_dropout=0.0,
                attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0)


def _configs(stage2, thrupdate):
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=100, segment_online=stage2,
              use_train_thrupdate=thrupdate, merge_threshold_range=(0.8, 0.8),
              thresholder_decay=0.99)
    return (jax_distill.DistillConfig(model=jax_hubert.HubertConfig(**_hub()), **kw),
            port_distill.DistillConfig(model=port_hubert.HubertConfig(**_hub()), **kw))


def mini_weights():
    """The JAX tree of ``mini_ckpt.npz`` without the layers past LAYERS."""
    tree = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    return {k: v for k, v in tree.items()
            if not k.startswith("layer_") or int(k.split("_")[1]) < LAYERS}


def _batch(stage2):
    ds = SyntheticSpeechDataset(n_utts=2, max_len=32000, with_segments=not stage2, seed=3)
    b = ds.collate([ds[0], ds[1]])
    b.pop("noise")
    return b


def _port_state(pcfg, tree):
    return port_distill.init_train_state(pcfg, "cpu", params=state_dict_from_jax_params(tree),
                                         thresholder_kwargs=THR)


def _port_batch(b):
    return {k: (torch.from_numpy(v) if v is not None else None) for k, v in b.items()}


def _jax_batch(b):
    return {k: (jnp.asarray(v) if v is not None else None) for k, v in b.items()}


def _grads_close(port_grads, jax_grads):
    def flat(d, p=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{p}{k}/")
            else:
                yield f"{p}{k}", np.asarray(v)
    got, want = dict(flat(port_grads)), dict(flat(jax_grads))
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-5 * max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol, (k, err, tol)


def check_gradients(stage2: bool):
    """The loss and every gradient leaf at the initial weights and, in stage
    2, the segments the step trains on, against JAX's (``use_train_thrupdate``
    changes neither)."""
    weights = mini_weights()
    jcfg, pcfg = _configs(stage2, True)
    batch = _batch(stage2)
    jb, pb = _jax_batch(batch), _port_batch(batch)
    rng = jax.random.PRNGKey(0)

    # gradients of the loss at the initial weights, leaf by leaf
    jstate = jax_distill.init_train_state(jcfg, rng, params=weights, thresholder_kwargs=THR)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_distill.distill_loss(p, jstate.ema_params, jstate.thresholder, jb,
                                           rng, jcfg), has_aux=True))(jstate.params)
    pstate = _port_state(pcfg, weights)
    ploss, paux = port_distill.distill_loss(
        pstate.student, pstate.teacher, pstate.thresholder, pb,
        port_distill.step_generators(0, 0, "cpu"), pcfg)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in pstate.student.named_parameters()}
    _grads_close(jax_params_from_state_dict(grads), jgrads)

    # the segments the step trains on (stage 2: found online on the teacher)
    if stage2:
        def jax_segments(params, b):
            target = jax_hubert.HubertModel(jcfg.model).apply(
                {"params": params}, b["input_values"], b["attention_mask"])
            fv = jax_hubert.feature_vector_attention_mask(
                jcfg.model, b["attention_mask"], target.shape[1]).astype(bool)
            res = jax_segment.segment_batch(target, get_threshold(jstate.thresholder), 0.8,
                                            frame_valid=fv)
            return res.segments, res.num_segments

        want_segs, want_n = jax.jit(jax_segments)(weights, jb)
        with torch.no_grad():
            pt = pstate.teacher(pb["input_values"], pb["attention_mask"]).float()
        fvp = port_hubert.feature_vector_attention_mask(pcfg.model, pb["attention_mask"],
                                                        pt.shape[1]).bool()
        got = port_segment.segment_batch(pt, port_distill.get_threshold(pstate.thresholder),
                                         0.8, frame_valid=fvp)
        assert np.array_equal(got.num_segments.numpy(), np.asarray(want_n))
        assert np.array_equal(got.segments.numpy(), np.asarray(want_segs))
        assert int(want_n.sum()) > 4



def check_steps(stage2: bool, thrupdate: bool):
    """Three steps of the port against JAX's: the first step's metrics and
    thresholder, the parameters after the third."""
    weights = mini_weights()
    jcfg, pcfg = _configs(stage2, thrupdate)
    batch = _batch(stage2)
    jb, pb = _jax_batch(batch), _port_batch(batch)
    rng = jax.random.PRNGKey(0)
    jstate = jax_distill.init_train_state(jcfg, rng, params=weights, thresholder_kwargs=THR)
    jstep = jax.jit(jax_distill.make_train_step(jcfg))
    pstep = port_distill.make_train_step(pcfg)
    pstate = _port_state(pcfg, weights)
    for i in range(3):
        jstate, jm = jstep(jstate, jb, jax.random.fold_in(rng, i))
        pm = pstep(pstate, pb, 0)
        if i == 0:
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
            assert int(pm["num_segments"]) == int(jm["num_segments"])
            for a, b in zip(pstate.thresholder, jstate.thresholder):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, equal_nan=True)
            if stage2:
                np.testing.assert_allclose(float(pm["normthreshold"]),
                                           float(jm["normthreshold"]), rtol=1e-5)
    assert pstate.step == 3
    got = jax_params_from_state_dict(pstate.student.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(want), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_stage1_gradients_match_jax():
    check_gradients(stage2=False)


def test_stage1_train_steps_match_jax():
    check_steps(stage2=False, thrupdate=False)


# ---- dropout and remat -------------------------------------------------------

TINY = dict(hidden_size=48, num_attention_heads=4, intermediate_size=96, conv_dim=(16,) * 7,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_hidden_layers=2,
            hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
            feat_proj_dropout=0.1)


def _tiny(**kw):
    model = port_hubert.HubertModel(port_hubert.HubertConfig(**dict(TINY, **kw)))
    return port_hubert.init_weights(model, torch.Generator().manual_seed(0))


def _inputs():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 16320).astype(np.float32))
    mask = torch.ones(2, 16320, dtype=torch.int32)
    mask[1, 10000:] = 0
    return x, mask


def test_dropout_is_seeded_and_eval_is_deterministic():
    m, (x, mask) = _tiny(), _inputs()
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    m.train()
    with torch.no_grad():
        a, b, c = m(x, mask, generator=gen(1)), m(x, mask, generator=gen(1)), m(x, mask,
                                                                            generator=gen(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        m.eval()
        e1, e2 = m(x, mask, generator=gen(1)), m(x, mask, generator=gen(2))
    assert torch.equal(e1, e2) and not torch.equal(e1, a)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_p(rate):
    from sylber_tpu_torch.ops.attention import Dropout

    x = torch.ones(200, 500)
    y = Dropout(7, "cpu")(x, rate)
    kept = float((y != 0).float().mean())
    n = x.numel()
    assert abs(kept - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5
    assert torch.allclose(y[y != 0], torch.full((), 1 / (1 - rate)))
    assert torch.equal(Dropout(7, "cpu")(x, rate), y)


def test_remat_equals_no_remat_with_dropout_on():
    x, mask = _inputs()
    plain, remat = _tiny(), _tiny(remat=True)
    remat.load_state_dict(plain.state_dict())
    losses, grads = [], []
    for m in (plain, remat):
        m.train()
        loss = m(x, mask, generator=torch.Generator().manual_seed(3)).square().mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(grads[0][k].abs().max()), err_msg=k)
