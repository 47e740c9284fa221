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
