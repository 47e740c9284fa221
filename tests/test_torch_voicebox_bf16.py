"""The voicebox ``Regressor`` with ``RegressorConfig(dtype=bfloat16)``.

The port against JAX's bf16 ``Regressor`` on the CPU, the trained
``mini_synth.npz`` weights (the skip-free mini config of
``test_torch_voicebox.py``; with GateLoop layers, the gateloop leaves of a
JAX init added), the same seeded inputs. Both compute every ``Dense`` in
bf16 from float32 parameters, so each product rounds its output to bf16,
and the two frameworks' bf16 products round apart by an ulp here and there
(oneDNN's and XLA's CPU kernels): a quarter to a third of the outputs are
equal bit for bit, and the gap is held at 1e-2 of the largest output after
one layer (measured 6.9e-3, under two bf16 ulps of the largest) and at
3e-2 after the mini model's four (measured 2.0e-2 without and 1.8e-2 with
GateLoop layers; JAX's own bf16 output sits 2.4e-2 / 2.1e-2 from its
float32 one). The output is bf16, as JAX's.

Also the oneDNN check of ``ROADMAP.md`` section 3 for the regressor's
depthwise ``conv_pos_embed`` (kernel 31): its bf16 form is right on this
CPU (unlike the grouped form of the HuBERT positional conv), and the port
runs it as an fp32 conv of bf16-rounded tensors either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sylber_tpu.models import voicebox as jvb
from sylber_tpu_torch.io.checkpoint import synthesis_state_dict_from_jax
from sylber_tpu_torch.models import voicebox as tvb

from test_torch_voicebox import MINI, _inputs, _trained_params  # noqa: E402
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def _with_gateloop(params):
    cfg = jvb.RegressorConfig(**MINI, use_gateloop_layers=True)
    x, emb, _ = _inputs(1, 8, MINI)
    init = jax.device_get(jax.jit(jvb.Regressor(cfg).init)(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.zeros((1,)), cond_emb=jnp.asarray(emb))["params"])
    params = dict(params, transformer=dict(params["transformer"]))
    for name, node in init["transformer"].items():
        if name.startswith("gateloop"):
            params["transformer"][name] = node
    return params


@pytest.mark.parametrize("gateloop,depth,tol", [(False, 1, 1e-2), (False, 4, 3e-2),
                                                (True, 4, 3e-2)],
                         ids=["depth1", "depth4", "depth4-gateloop"])
def test_bf16_regressor_matches_jax(gateloop, depth, tol):
    params = _trained_params(False)
    if gateloop:
        params = _with_gateloop(params)
    params = dict(params, transformer={k: v for k, v in params["transformer"].items()
                                       if not any(k.endswith(f"_{i}") for i in range(depth, 4))})
    kw = dict(MINI, depth=depth, use_gateloop_layers=gateloop)
    x, emb, times = _inputs(3, 53, MINI, seed=2)
    want = jax.jit(jvb.Regressor(jvb.RegressorConfig(**kw, dtype=jnp.bfloat16)).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(times), cond_emb=jnp.asarray(emb))
    port = tvb.Regressor(tvb.RegressorConfig(**kw, dtype="bfloat16"))
    port.load_state_dict(synthesis_state_dict_from_jax(
        {"regressor": params, "input_mlp": {}})["regressor"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.as_tensor(times), cond_emb=torch.from_numpy(emb))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want, got = np.asarray(want, np.float32), got.float().numpy()
    err = np.abs(got - want)
    assert err.max() <= tol * np.abs(want).max(), (err.max(), np.abs(want).max())
    assert (err == 0).mean() > 0.15


def test_bf16_depthwise_conv_pos_embed_on_cpu_is_right():
    """oneDNN's bf16 depthwise conv (512 channels, kernel 31) against the
    fp32 conv of the same bf16 values: within half a bf16 ulp of the output
    (its own rounding), where the grouped conv of
    ``test_bf16_positional_conv_on_cpu_is_fp32_on_rounded_tensors`` is off
    by units. The port's bf16 regressor takes the fp32 form regardless."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 512, 265, generator=g) * 5).bfloat16()
    w = (torch.randn(512, 1, 31, generator=g) / 31 ** 0.5).bfloat16()
    b = (torch.randn(512, generator=g) * 0.1).bfloat16()
    native = F.conv1d(F.pad(x, (15, 15)), w, b, groups=512).float()
    exact = F.conv1d(F.pad(x.float(), (15, 15)), w.float(), b.float(), groups=512)
    ulp = torch.finfo(torch.bfloat16).eps * exact.abs().clamp_min(1e-30)
    assert bool(((native - exact).abs() <= ulp).all())
    port = tvb.Regressor(tvb.RegressorConfig(**MINI, dtype="bfloat16"))
    assert port.cfg.dtype == torch.bfloat16
