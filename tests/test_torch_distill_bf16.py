"""The bf16 training path of the port against ``sylber_tpu``: the recipe's
``dtype``/``frontend_dtype`` bfloat16 at ``default`` precision.

- The frontend at ``frontend_dtype`` bf16, whose layer 0 takes the analytic
  GroupNorm moments and tanh GELU (``models/hubert.py::conv0_layer_xla``),
  against JAX's ``ConvFeatureEncoder`` on the same weights: the output and
  the gradient of a fixed projection of it with respect to every frontend
  weight. Tolerance 2e-2 of the largest value: a few bf16 roundings (one is
  2^-8 relative) on each side.
- One stage-1 step, every dropout 0, on two layers of ``mini_ckpt.npz``
  against ``sylber_tpu.train.distill.distill_loss``: loss rtol 2e-2, each
  gradient leaf within 5e-2 of its largest value (bf16 activations through
  two layers and their backward, rounded in a different order on each side;
  the leaves differ by 0.3-1.7 % of their largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.train import distill as jax_distill
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert
from sylber_tpu_torch.train import distill as port_distill
from test_torch_distill import THR, _batch, _hub, _jax_batch, _port_batch, \
    mini_weights  # noqa: E402 (same-dir test module)

BF16 = dict(dtype="bfloat16", frontend_dtype="bfloat16", precision="default")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _leaves_close(got, want, rel):
    """Each leaf within ``rel`` of its largest value, and never held closer
    than ``rel`` of a hundredth of the tree's largest: the key bias's
    gradient is zero in exact arithmetic (softmax ignores a constant added
    to a row of scores), so both sides hold rounding noise there."""
    assert got.keys() == want.keys()
    floor = 1e-2 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        w, g = np.asarray(want[k], np.float32), np.asarray(got[k], np.float32)
        tol = rel * max(floor, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= tol, (k, err, tol)


def test_bf16_analytic_frontend_matches_jax():
    hub = dict(conv_dim=(16,) * 7, **BF16)
    jcfg, pcfg = jax_hubert.HubertConfig(**hub), port_hubert.HubertConfig(**hub)
    rng = np.random.RandomState(11)
    x = (0.3 * rng.randn(2, 16320) + 0.2).astype(np.float32)  # a DC offset: the mean matters
    proj = rng.randn(50, 16).astype(np.float32)  # T = 50 frames, conv_dim 16

    enc = jax_hubert.ConvFeatureEncoder(jcfg)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(  # non-trivial GroupNorm affine
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), jnp.float32), params)

    def jax_fn(p):
        y = enc.apply({"params": p}, jnp.asarray(x))
        return (y * jnp.asarray(proj)).sum(), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(params)

    port = port_hubert.ConvFeatureEncoder(pcfg)
    sd = state_dict_from_jax_params({"feature_extractor": params})
    port.load_state_dict({k[len("feature_extractor."):]: v for k, v in sd.items()})
    py = port(torch.from_numpy(x), differentiable=True)
    (py * torch.from_numpy(proj)).sum().backward()

    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               atol=2e-2 * float(np.abs(np.asarray(jy)).max()), rtol=0)
    grads = {f"feature_extractor.{k}": p.grad for k, p in port.named_parameters()}
    got = jax_params_from_state_dict(grads)["feature_extractor"]
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    _leaves_close(flat(got), flat(jgrads), 2e-2)


def test_bf16_stage1_gradients_match_jax():
    weights = mini_weights()
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=100, segment_online=False,
              merge_threshold_range=(0.8, 0.8))
    jcfg = jax_distill.DistillConfig(model=jax_hubert.HubertConfig(**dict(_hub(), **BF16)), **kw)
    pcfg = port_distill.DistillConfig(model=port_hubert.HubertConfig(**dict(_hub(), **BF16)),
                                      **kw)
    batch = _batch(False)
    jb, pb = _jax_batch(batch), _port_batch(batch)
    rng = jax.random.PRNGKey(0)
    jstate = jax_distill.init_train_state(jcfg, rng, params=weights, thresholder_kwargs=THR)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_distill.distill_loss(p, jstate.ema_params, jstate.thresholder, jb,
                                           rng, jcfg), has_aux=True))(jstate.params)
    pstate = port_distill.init_train_state(pcfg, "cpu", params=state_dict_from_jax_params(weights),
                                           thresholder_kwargs=THR)
    ploss, _ = port_distill.distill_loss(pstate.student, pstate.teacher, pstate.thresholder, pb,
                                         port_distill.step_generators(0, 0, "cpu"), pcfg)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=2e-2)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in pstate.student.named_parameters()}
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    _leaves_close(flat(jax_params_from_state_dict(grads)), flat(jgrads), 5e-2)


@pytest.mark.parametrize("records", [True, False], ids=["autograd", "no_grad"])
def test_bf16_positional_conv_on_cpu_is_fp32_on_rounded_tensors(monkeypatch, records):
    """On the CPU the bf16 positional conv is always the fp32 conv of the
    bf16-rounded input, weight and bias, cast to bf16 (oneDNN's bf16 grouped
    conv gives wrong sums in torch 2.13's CPU build; on CUDA the model picks
    cuDNN's bf16 form for small no-grad calls)."""
    cfg = port_hubert.HubertConfig(hidden_size=32, num_conv_pos_embeddings=16,
                                   num_conv_pos_embedding_groups=4, **BF16)
    pos = port_hubert.PositionalConvEmbedding(cfg)
    torch.nn.init.normal_(pos.conv.weight, 0.0, 0.1, generator=torch.Generator().manual_seed(0))
    seen, conv1d = [], port_hubert.F.conv1d
    monkeypatch.setattr(port_hubert.F, "conv1d",
                        lambda x, *a, **k: seen.append(x.dtype) or conv1d(x, *a, **k))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 20, 32).astype(np.float32))
    x = x.to(torch.bfloat16)
    with torch.set_grad_enabled(records):
        y = pos(x)
    assert seen == [torch.float32]
    with torch.no_grad():
        w, b = (t.to(torch.bfloat16).float() for t in (pos.conv.weight, pos.conv.bias))
        ref = conv1d(x.transpose(1, 2).float(), w, b, padding=pos.conv.padding,
                     groups=pos.conv.groups).to(torch.bfloat16)[:, :, :-1]
        ref = port_hubert._gelu(ref, cfg.gelu_approximate).transpose(1, 2)
    assert torch.equal(y.detach(), ref)
