"""The port's int8 serving mode against the JAX package, on the CPU.

On the CPU the wrappers of ``ops/int8.py`` run their plain versions; the
kernels themselves are held against those in ``test_torch_cuda_emu_int8.py``
(g++ stand-in) and ``chip_smoke.py`` phase 9 (the card).

- ``quantize_symmetric``: bit-equal to JAX along either axis, with zero rows
  and bf16 input;
- ``int8_dense``: float32 output within 1e-6 of the largest output, bf16
  within one bf16 ulp; integer-valued operands bit-equal to the float
  product (``tests/unit/test_int8.py``'s exact grid);
- the q/k/v weights quantized row by row into one buffer equal the
  quantization of their concatenation;
- the weights' cache (``QuantizedWeights``): quantized once, then again
  only after ``load_state_dict``, an in-place ``copy_`` or ``.to(dtype)``,
  each giving a fresh module's output bit for bit; ``state_dict`` keys
  unchanged; a deep copy starts empty;
- the encoder: ``int8_encoder`` (fp32 and bf16) against JAX's by per-frame
  cosine, ``fused_qkv`` at 1e-5; the int8 mode refuses autograd, train mode
  and the distillation trainer; ``serve_http --int8`` builds its config;
- the slice: the ``mini_ckpt.npz`` Segmenter in int8 + bf16 against JAX's
  on phase 4's held-out utterances, and against the port's fp32 program, at
  boundary F1 >= 0.995 (tolerance 0).
"""

import copy
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import speechlike
from sylber_tpu.api import Segmenter as JaxSegmenter
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.ops.int8 import int8_dense as jax_int8_dense
from sylber_tpu.ops.int8 import quantize_symmetric
from sylber_tpu_torch import Segmenter, serve_http
from sylber_tpu_torch.io.checkpoint import state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert
from sylber_tpu_torch.ops import int8 as port_int8
from sylber_tpu_torch.train.distill import DistillConfig, make_train_step
from sylber_tpu_torch.utils.metrics import boundary_f1
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
# tests/unit/test_int8.py's _small_cfg
SMALL = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, conv_dim=(24,) * 7, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_symmetric_is_bit_equal_to_jax(axis, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(40, 33) * rng.uniform(0.01, 50.0, (40, 1))).astype(np.float32)
    x[5], x[:, 7] = 0.0, 0.0  # a zero row and a zero column: the 1e-8 floor
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jq, js = quantize_symmetric(jx.astype(jnp.float32), axis=axis)
    tq, ts = port_int8.quantize_symmetric_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                                                dim=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    if axis == -1:  # the dispatch's CPU path
        q, s = port_int8.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(js)[:, 0]))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(out_dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(8, 100, 96).astype(np.float32)
    w = (rng.randn(96, 128) / np.sqrt(96)).astype(np.float32)  # JAX (K, N)
    b = (rng.randn(128) * 0.1).astype(np.float32)
    want = np.asarray(jax_int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     out_dtype=jnp.dtype(out_dtype)).astype(jnp.float32))
    got = port_int8.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                               torch.from_numpy(b), getattr(torch, out_dtype))
    assert got.shape == (8, 100, 128) and got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    exact = x @ w + b  # the quantization error model of tests/unit/test_int8.py
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02


def test_int8_dense_exact_on_representable_grid():
    rng = np.random.RandomState(2)
    x = rng.randint(-127, 128, (4, 32)).astype(np.float32)
    w = rng.randint(-127, 128, (32, 16)).astype(np.float32)
    x[:, 0], w[0, :] = 127.0, 127.0  # scale exactly 1 in every row and column
    got = port_int8.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy())).numpy()
    np.testing.assert_array_equal(got, x @ w)
    np.testing.assert_array_equal(got, np.asarray(jax_int8_dense(jnp.asarray(x),
                                                                 jnp.asarray(w))))


def test_qkv_weights_quantized_row_by_row_equal_the_concatenation():
    rng = np.random.RandomState(3)
    ws = [torch.from_numpy((rng.randn(24, 40) * s).astype(np.float32)) for s in (0.1, 2.0, 0.02)]
    q, s = port_int8.quantize_weights(ws)
    cq, cs = port_int8.quantize_rows(torch.cat(ws))
    assert torch.equal(q, cq) and torch.equal(s, cs)
    jq, js = quantize_symmetric(jnp.asarray(torch.cat(ws).T.numpy()), axis=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)


@functools.lru_cache(maxsize=1)
def _small_params():
    return jax_hubert.HubertModel(jax_hubert.HubertConfig(**SMALL)).init_params(
        jax.random.PRNGKey(0), example_len=8000)


def _encoders(kw):
    params = _small_params()
    jkw = {k: jnp.bfloat16 if v == "bfloat16" else v for k, v in kw.items()}
    jax_model = jax_hubert.HubertModel(jax_hubert.HubertConfig(**SMALL, **jkw))
    port = port_hubert.HubertModel(port_hubert.HubertConfig(**SMALL, **kw))
    port.load_state_dict(state_dict_from_jax_params(params))
    return params, jax_model, port.eval()


def _hidden(kw, seed=3):
    rng = np.random.RandomState(seed)
    wav = rng.randn(2, 8000).astype(np.float32)
    mask = np.ones((2, 8000), np.int32)
    wav[1, 5000:], mask[1, 5000:] = 0.0, 0
    params, jax_model, port = _encoders(kw)
    want = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(wav),
                                               jnp.asarray(mask)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(mask)).float().numpy()
    valid = port.cfg.feat_extract_output_length(np.array([8000, 5000]))
    return [(got[i, :t], want[i, :t]) for i, t in enumerate(valid)], port


def _int8_port(sd):
    port = port_hubert.HubertModel(port_hubert.HubertConfig(**SMALL, int8_encoder=True))
    port.load_state_dict(sd)
    return port.eval()


def _run(port, wav):
    with torch.no_grad():
        return port(wav)


@pytest.fixture
def weight_quantizations(monkeypatch):
    """The weight groups quantized since the fixture began (the cache's misses)."""
    calls = []
    real = port_int8.quantize_weights

    def counted(weights):
        calls.append(len(weights))
        return real(weights)

    monkeypatch.setattr(port_int8, "quantize_weights", counted)
    return calls


def test_weights_quantized_once_and_again_after_load_state_dict(weight_quantizations):
    sd = state_dict_from_jax_params(_small_params())
    sd2 = {k: v * 1.25 for k, v in sd.items()}
    wav = torch.from_numpy(np.random.RandomState(7).randn(1, 4000).astype(np.float32))
    port = _int8_port(sd)
    first = _run(port, wav)
    groups = 4 * SMALL["num_hidden_layers"]  # q/k/v, out, and the feed-forward pair a layer
    assert len(weight_quantizations) == groups
    assert torch.equal(_run(port, wav), first) and len(weight_quantizations) == groups
    port.load_state_dict(sd2)
    got = _run(port, wav)
    assert len(weight_quantizations) == 2 * groups
    assert torch.equal(got, _run(_int8_port(sd2), wav)) and not torch.equal(got, first)


def test_weights_cache_sees_an_in_place_copy():
    sd = state_dict_from_jax_params(_small_params())
    wav = torch.from_numpy(np.random.RandomState(8).randn(1, 4000).astype(np.float32))
    port = _int8_port(sd)
    first = _run(port, wav)
    names = ["layers.0.attention.k_proj.weight", "layers.1.intermediate_dense.weight"]
    sd2 = dict(sd)
    for name in names:
        sd2[name] = sd[name].flip(0).contiguous()
        with torch.no_grad():
            port.get_parameter(name).copy_(sd2[name])
    got = _run(port, wav)
    assert torch.equal(got, _run(_int8_port(sd2), wav)) and not torch.equal(got, first)


def test_weights_cache_after_to_dtype():
    layer = torch.nn.Linear(40, 24)
    cache = port_int8.QuantizedWeights()
    q32, s32 = cache("w", [layer.weight])
    assert cache("w", [layer.weight])[0] is q32  # unchanged: the same operand
    layer.to(torch.bfloat16)
    qb, sb = cache("w", [layer.weight])
    want_q, want_s = port_int8.quantize_weights([layer.weight])
    assert torch.equal(qb, want_q) and torch.equal(sb, want_s)
    assert not torch.equal(qb, q32)


def test_weights_cache_leaves_the_state_dict_and_copies_alone():
    sd = state_dict_from_jax_params(_small_params())
    wav = torch.from_numpy(np.random.RandomState(9).randn(1, 4000).astype(np.float32))
    port = _int8_port(sd)
    got = _run(port, wav)
    plain = port_hubert.HubertModel(port_hubert.HubertConfig(**SMALL))
    assert list(port.state_dict()) == list(plain.state_dict())
    twin = copy.deepcopy(port)
    assert not twin.layers[0]._int8_weights._entries
    assert torch.equal(_run(twin, wav), got)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_int8_encoder_matches_jax(mode):
    """Per-frame cosine against JAX's int8 encoder with the same weights.
    float32 at "highest": the operands quantize to the same int8 values, so
    every element is within 1e-5 (seen: 1.5e-6 at the most, so no quantized
    value a step apart). bf16 at "default": the frameworks round the bf16
    activations at other places, so quantized values sit a step apart (1,653
    of 1,872 elements differ by more than 1e-3); the cosine holds (seen:
    0.99973 at the least) and the elements within 0.1 (seen: 0.069)."""
    kw = dict(int8_encoder=True, precision="highest")
    if mode == "bfloat16":
        kw.update(dtype="bfloat16", frontend_dtype="bfloat16", precision="default")
    pairs, _ = _hidden(kw)
    for got, want in pairs:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() > (0.99999 if mode == "float32" else 0.9995), cos.min()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if mode == "float32" else 0.1)


def test_fused_qkv_matches_jax():
    pairs, port = _hidden(dict(fused_qkv=True, precision="highest"))
    assert port.layers[0].attention.fused_qkv
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_int8_encoder_refuses_autograd_train_mode_and_the_trainer():
    _, _, port = _encoders(dict(int8_encoder=True))
    wav = torch.from_numpy(np.random.RandomState(4).randn(1, 4000).astype(np.float32))
    with pytest.raises(RuntimeError, match="inference"):
        port(wav)  # autograd records
    with torch.no_grad(), pytest.raises(RuntimeError, match="inference"):
        port.train()(wav)
    with torch.no_grad():
        assert torch.isfinite(port.eval()(wav)).all()
    with pytest.raises(ValueError, match="int8_encoder"):
        make_train_step(DistillConfig(model=port_hubert.HubertConfig(**SMALL,
                                                                     int8_encoder=True)))


def test_serve_http_int8_builds_the_int8_config():
    cfg = serve_http.segmenter_config(9, int8=True)
    assert cfg.int8_encoder and cfg.dtype == torch.bfloat16
    assert cfg.frontend_dtype == torch.bfloat16 and cfg.precision == "default"
    fast = serve_http.segmenter_config(9, bf16=True)
    assert not fast.int8_encoder and fast.dtype == torch.bfloat16
    exact = serve_http.segmenter_config(3)
    assert exact.num_hidden_layers == 3 and exact.dtype == torch.float32
    assert not exact.int8_encoder


def test_mini_ckpt_int8_segmenter_matches_jax_and_the_exact_program():
    """The slice as a whole: four of phase 4's held-out utterances (seed
    9999, 3-8 s), the int8 + bf16 Segmenter of the port against JAX's and
    against the port's fp32 exact program."""
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    kw = dict(norm_threshold=meta["norm_threshold"], merge_threshold=meta["merge_threshold"])
    fast = dict(dtype="bfloat16", frontend_dtype="bfloat16", precision="default",
                int8_encoder=True)
    rng = np.random.RandomState(9999)
    wavs = [speechlike(rng, int(rng.uniform(3.0, 8.0) * 16000)) for _ in range(4)]
    ckpt = str(FIXTURES / "mini_ckpt.npz")
    port = Segmenter(model_ckpt=ckpt, hubert_config=port_hubert.HubertConfig(**hub, **fast),
                     device="cpu", **kw)
    exact = Segmenter(model_ckpt=ckpt, hubert_config=port_hubert.HubertConfig(**hub),
                      device="cpu", **kw)
    jfast = {k: jnp.bfloat16 if v == "bfloat16" else v for k, v in fast.items()}
    jax_seg = JaxSegmenter(params=jax_load_npz(ckpt),
                           hubert_config=jax_hubert.HubertConfig(**hub, **jfast), **kw)
    got = port.process(wavs, in_second=False, return_hidden=False)
    want = jax_seg(wav=wavs, in_second=False)
    ref = exact.process(wavs, in_second=False, return_hidden=False)
    nseg = sum(len(g["segments"]) for g in got)
    assert nseg > 50
    for other in (want, ref):
        f1 = np.mean([boundary_f1(g["segments"], o["segments"], tol_frames=0)
                      for g, o in zip(got, other)])
        assert f1 >= 0.995, f1
