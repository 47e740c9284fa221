"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``sylber_tpu_torch`` runs its plain PyTorch
version; the JAX kernels run in Pallas interpret mode. Inputs are made from
a seed with numpy and handed to both. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops.pallas import flash as jax_flash
from sylber_tpu.ops.pallas.frontend import fused_conv0_gn_gelu
from sylber_tpu.ops.pallas.smallattn import fused_attention_small
from sylber_tpu_torch.ops.attention import attention
from sylber_tpu_torch.ops.flash import flash_attention
from sylber_tpu_torch.ops.frontend import conv0_gn_gelu
from sylber_tpu_torch.ops.segment import segment_pass1
from sylber_tpu_torch.ops.smallattn import small_attention


@pytest.fixture
def flash_interpret(monkeypatch):
    """Run the JAX flash kernel's pallas_call in interpret mode."""
    orig = jax_flash.pl.pallas_call
    monkeypatch.setattr(jax_flash.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    jax_flash._flash._clear_cache()
    yield
    jax_flash._flash._clear_cache()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("pad_from", [None, 3000])
def test_conv0_gn_gelu_matches_pallas(pad_from):
    """Including a zero-padded item: padding enters the GroupNorm moments."""
    rng = np.random.RandomState(0)
    B, L, D = 2, 6400, 32
    x = rng.randn(B, L).astype(np.float32)
    if pad_from is not None:
        x[1, pad_from:] = 0.0
    w = (rng.randn(10, 1, D) / np.sqrt(10)).astype(np.float32)  # flax layout
    gamma = rng.uniform(0.5, 1.5, D).astype(np.float32)
    beta = (0.1 * rng.randn(D)).astype(np.float32)
    want = np.asarray(fused_conv0_gn_gelu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta),
        interpret=True))
    got = conv0_gn_gelu(_t(x), _t(np.transpose(w, (2, 1, 0))), _t(gamma), _t(beta))
    assert got.shape == (B, D, want.shape[1])
    np.testing.assert_allclose(_np(got).transpose(0, 2, 1), want,
                               rtol=2e-4, atol=2e-4)


def _qkv(rng, B, H, L, D):
    return [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_small_attention_matches_pallas(dtype, tol):
    """Ragged kv_len with a fully padded item: both give the uniform mean."""
    rng = np.random.RandomState(1)
    q, k, v = _qkv(rng, 3, 4, 120, 64)
    lens = np.array([120, 73, 0], np.int32)
    jdt = jnp.dtype(dtype)
    want = fused_attention_small(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 kv_len=jnp.asarray(lens), interpret=True)
    tdt = getattr(torch, dtype)
    got = small_attention(*(_t(a, tdt) for a in (q, k, v)), torch.from_numpy(lens))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_attention_matches_pallas(flash_interpret, scale):
    """Key padding, a fully padded item (0 from both) and a scale override."""
    rng = np.random.RandomState(2)
    B, H, L, D = 3, 2, 640, 32
    q, k, v = _qkv(rng, B, H, L, D)
    lens = np.array([640, 211, 0], np.int32)
    valid = np.arange(L)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min)[:, None, None, :]
    want = jax_flash.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     bias=jnp.asarray(bias, jnp.float32),
                                     scale=scale)
    got = flash_attention(*(_t(a) for a in (q, k, v)), torch.from_numpy(lens),
                          scale=scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert not _np(got)[2].any()


def _bhld_views(arrays, dtype):
    """(B, H, L, D) tensors that are views of (B, L, H, D) memory, as the
    encoder layer hands its projections to the attention core."""
    return [_t(a, dtype).transpose(1, 2).contiguous().transpose(1, 2) for a in arrays]


_EDGE_DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]


@pytest.mark.parametrize("dtype,tol", _EDGE_DTYPES)
@pytest.mark.parametrize("D", [12, 64])
@pytest.mark.parametrize("L", [77, 250])
def test_small_attention_edges_match_pallas(L, D, dtype, tol):
    """kv_len 0, 1, L-1 and L in one batch; the kv_len == 0 item is the mean
    of V; strided (B, L, H, D) views give what contiguous inputs give."""
    rng = np.random.RandomState(10 * L + D)
    q, k, v = _qkv(rng, 4, 2, L, D)
    lens = np.array([0, 1, L - 1, L], np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(fused_attention_small(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), kv_len=jnp.asarray(lens),
        interpret=True), np.float32)
    got = small_attention(*(_t(a, tdt) for a in (q, k, v)), torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    mean_v = _np(_t(v[0], tdt)).mean(axis=1, keepdims=True)  # (H, 1, D)
    np.testing.assert_allclose(_np(got)[0], np.broadcast_to(mean_v, got.shape[1:]),
                               rtol=tol, atol=tol)
    views = _bhld_views((q, k, v), tdt)
    assert not views[0].is_contiguous()
    strided = small_attention(*views, torch.from_numpy(lens))
    assert strided.shape == got.shape
    np.testing.assert_array_equal(_np(strided), _np(got))


@pytest.mark.parametrize("dtype,tol", _EDGE_DTYPES)
@pytest.mark.parametrize("D", [12, 64])
@pytest.mark.parametrize("L", [513, 600])
def test_flash_attention_edges_match_pallas(flash_interpret, L, D, dtype, tol):
    """kv_len 0, 1, L-1 and L in one batch; the kv_len == 0 item is 0;
    strided (B, L, H, D) views give what contiguous inputs give."""
    rng = np.random.RandomState(10 * L + D)
    q, k, v = _qkv(rng, 4, 2, L, D)
    lens = np.array([0, 1, L - 1, L], np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    valid = np.arange(L)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min)[:, None, None, :]
    want = np.asarray(jax_flash.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        bias=jnp.asarray(bias, jnp.float32)), np.float32)
    got = flash_attention(*(_t(a, tdt) for a in (q, k, v)), torch.from_numpy(lens))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    assert not _np(got)[0].any()
    strided = flash_attention(*_bhld_views((q, k, v), tdt), torch.from_numpy(lens))
    np.testing.assert_array_equal(_np(strided), _np(got))


def test_attention_layer_takes_strided_heads():
    """The encoder layer's attention hands (B, L, H, D) projections to the
    core as strided views; the result equals the copying formulation."""
    from sylber_tpu_torch.ops.attention import MultiHeadSelfAttention

    torch.manual_seed(0)
    B, L, d, h = 2, 40, 48, 4
    layer = MultiHeadSelfAttention(d, h)
    x = _t(np.random.RandomState(4).randn(B, L, d))
    lens = torch.tensor([40, 23], dtype=torch.int32)
    with torch.no_grad():
        got = layer(x, lens, torch.float32)
        want = _copying_attention_layer(layer, x, lens)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def _copying_attention_layer(layer, x, lens):
    from sylber_tpu_torch.ops.attention import linear

    B, L, d = x.shape
    h = layer.num_heads
    split = lambda p: linear(x, p, torch.float32).reshape(  # noqa: E731
        B, L, h, d // h).transpose(1, 2).contiguous()
    core = attention(split(layer.q_proj), split(layer.k_proj), split(layer.v_proj), lens)
    return linear(core.transpose(1, 2).reshape(B, L, d), layer.out_proj, torch.float32)


def test_attention_dispatch_on_cpu_is_the_xla_path():
    """CPU tensors take the plain path at any length, flash lengths included."""
    from sylber_tpu.ops.attention import dot_product_attention

    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 2, 2, 600, 16)
    lens = np.array([600, 350], np.int32)
    valid = np.arange(600)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min)[:, None, None, :]
    want = dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 bias=jnp.asarray(bias, jnp.float32))
    got = attention(*(_t(a) for a in (q, k, v)), torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    calls = [
        lambda: conv0_gn_gelu(meta(2, 800), meta(8, 1, 10), meta(8), meta(8)),
        lambda: small_attention(meta(2, 2, 16, 8), meta(2, 2, 16, 8),
                                meta(2, 2, 16, 8), lens),
        lambda: flash_attention(meta(2, 2, 16, 8), meta(2, 2, 16, 8),
                                meta(2, 2, 16, 8), lens),
        lambda: segment_pass1(meta(2, 16, 8),
                              torch.empty(2, 16, dtype=torch.bool, device="meta"), 0.8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
