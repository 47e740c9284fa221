"""The int8 and GateLoop kernels' CUDA sources, run on the CPU.

``int8_gemm.cu`` (the row quantizer and the int8 GEMM) and ``gateloop.cu``
are compiled by g++ against the host stand-in of ``tests/cuda_emu`` (built by
``test_torch_cuda_emu.py``'s helper; ``emu.cpp`` emulates after the PTX ISA
the GEMM's TMA 2-D tile loads with the 128-byte swizzle and out-of-bounds
zeros, its full and empty mbarriers, ``wgmma`` m64n128k32 s8 through
shared-memory descriptors with the accumulator fragment's layout, and
``cuTensorMapEncodeTiled`` on the host) and driven through the
wrappers' own launch code (``ops/int8.py``, ``ops/gateloop.py``). The same
numpy inputs go through the JAX package (``quantize_symmetric``,
``int8_dense``, ``gate_loop_operator``) and the port's plain versions.

- the quantizer: bit-equal to both, at 16-byte and scalar loads, bf16
  input, a strided input, zero rows, rows held in registers (1, 2, 3 and 24
  pieces a lane) and a K past that width (read twice); the padded tail of
  each row is zero; rows whose quotients
  lie at and next to half-integers (``chip_smoke.half_integer_rows``, which
  hold values where the reciprocal's product alone rounds otherwise), fp32
  and bf16, at 16-byte and scalar loads; the weights' ``out=`` row slices
  of one buffer;
- the GEMM: bit-equal to the plain version (int32 sums are exact and the
  epilogue rounds as it does), against JAX at 1e-6 of the largest output in
  float32 and one bf16 ulp in bf16, at K tails (20, 48, 144: not multiples
  of the 32-byte step, 20 not of 16 either), ragged M and N (M 1, N odd),
  no bias, a strided output, a K of eight 128-byte tiles, so that the ring
  of six stages wraps and the producer waits for stages to come back, and 9
  output tiles on the stand-in's 3 SMs, so that a block of the persistent
  grid takes 3 tiles and the ring runs on across them;
- the GateLoop kernel (a chunked scan): bit-equal to the plain version on
  thirds of one (B, L, 3D) product, and within the order gap of JAX's scan,
  at lengths below, at and just past a chunk, with more chunks than a block
  has warps and over five segments, and widths off the 32 lanes.

A separate file from ``test_torch_cuda_emu.py`` so that a distributed run can
give it a worker of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops.gateloop import gate_loop_operator as jax_gate_loop
from sylber_tpu.ops.int8 import int8_dense as jax_int8_dense
from sylber_tpu.ops.int8 import quantize_symmetric
from chip_smoke import half_integer_rows, reciprocal_disagreements
from sylber_tpu_torch.ops import gateloop as port_gateloop
from sylber_tpu_torch.ops import int8 as port_int8
from test_torch_cuda_emu import _check, build_host_library
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

F32, BF16 = torch.float32, torch.bfloat16
ENTRY_POINTS = ["sylber_quantize_rows", "sylber_int8_gemm", "sylber_gate_loop"]
# the scan (JAX) and the chunked order (kernel, plain) round differently
GATELOOP_RTOL = 1e-6


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_host_library(tmp_path_factory.mktemp("cuda_emu_int8"),
                              ("common.cuh", "int8_gemm.cu", "gateloop.cu"), ENTRY_POINTS)


@pytest.fixture
def on_host(emulated, monkeypatch):
    """The wrappers' launch code bound to the host library."""
    for mod in (port_int8, port_gateloop):
        monkeypatch.setattr(mod, "lib", lambda: emulated)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
        monkeypatch.setattr(mod, "check", _check)


def _quantize(x: torch.Tensor):
    """``quantize_rows``'s CUDA path on the host: a padded, zero-tailed buffer."""
    R, K = x.shape
    q = torch.full((R, port_int8.padded_width(K)), 99, dtype=torch.int8)  # tail must be zeroed
    s = torch.empty(R, dtype=torch.float32)
    port_int8._launch_quantize(x, q, s)
    return q, s


QUANTIZE_CASES = [
    # name, rows, width, dtype, row stride (None: contiguous)
    ("f32-vec", 37, 144, F32, None),
    ("f32-scalar", 9, 50, F32, None),        # 50 % 4: one value a load
    ("bf16-vec", 12, 48, BF16, None),
    ("bf16-scalar-tail", 7, 20, BF16, None),  # 20 % 8, and the padded width is 32
    ("f32-strided", 11, 144, F32, 200),
    ("bf16-k768-held", 60, 768, BF16, None),  # 3 pieces a lane
    ("f32-k3072-held", 5, 3072, F32, None),  # 24 pieces a lane, no row loaded ahead
    ("f32-k3200-wide", 3, 3200, F32, None),  # past the register-held width: read twice
]


@pytest.mark.parametrize("name,R,K,dtype,ld", QUANTIZE_CASES, ids=[c[0] for c in QUANTIZE_CASES])
def test_emulated_quantize_rows_is_bit_equal(on_host, name, R, K, dtype, ld):
    rng = np.random.RandomState(R * K)
    x = rng.randn(R, ld or K).astype(np.float32) * rng.uniform(0.01, 30.0, (R, 1))
    x[R // 2] = 0.0  # a zero row: the 1e-8 floor of the scale
    xt = torch.from_numpy(x).to(dtype)[:, :K]
    _assert_quantized_as_plain_and_jax(xt, *_quantize(xt))


def _assert_quantized_as_plain_and_jax(xt, q, s):
    K = xt.shape[1]
    want_q, want_s = port_int8.quantize_symmetric_plain(xt)
    np.testing.assert_array_equal(q[:, :K].numpy(), want_q.numpy())
    np.testing.assert_array_equal(s.numpy().view(np.int32), want_s[:, 0].numpy().view(np.int32))
    assert not q[:, K:].any()
    jq, js = quantize_symmetric(jnp.asarray(xt.float().numpy()), axis=-1)
    np.testing.assert_array_equal(q[:, :K].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js)[:, 0].view(np.int32))


HALF_INTEGER_CASES = [("f32-vec", F32, 144), ("f32-scalar", F32, 50), ("bf16-vec", BF16, 48),
                      ("bf16-scalar", BF16, 44)]


@pytest.mark.parametrize("name,dtype,K", HALF_INTEGER_CASES,
                         ids=[c[0] for c in HALF_INTEGER_CASES])
def test_emulated_quantize_rows_at_half_integer_quotients(on_host, name, dtype, K):
    x = half_integer_rows(np.random.RandomState(K), 32, K, str(dtype)[6:])
    assert reciprocal_disagreements(x) > 0  # values the reciprocal's product alone gets wrong
    xt = torch.from_numpy(x).to(dtype)
    assert torch.equal(xt.float(), torch.from_numpy(x))
    _assert_quantized_as_plain_and_jax(xt, *_quantize(xt))


def test_emulated_quantize_rows_fills_out_row_slices(on_host):
    """``quantize_weights``'s launches on the CUDA path: each weight into its
    row slice of one padded buffer, equal to quantizing the concatenation."""
    rng = np.random.RandomState(5)
    ws = [torch.from_numpy((rng.randn(n, 40) * sc).astype(np.float32))
          for n, sc in ((24, 0.1), (24, 2.0), (8, 0.02))]
    q = torch.full((56, port_int8.padded_width(40)), 99, dtype=torch.int8)
    s = torch.full((56,), float("nan"))
    r = 0
    for w in ws:
        port_int8._launch_quantize(w, q[r:r + len(w)], s[r:r + len(w)])
        r += len(w)
    _assert_quantized_as_plain_and_jax(torch.cat(ws), q, s)


GEMM_CASES = [
    # name, M, K, N, out dtype, bias, strided output
    ("mini-width", 100, 144, 72, F32, True, False),
    ("two-by-two-blocks", 130, 48, 200, BF16, True, False),
    ("one-row-odd-n", 1, 144, 13, F32, True, False),
    ("k-tail-of-20", 257, 20, 9, BF16, False, False),
    ("strided-out", 70, 144, 33, F32, True, True),
    ("strided-out-bf16", 70, 48, 40, BF16, False, True),
    ("ring-wraps", 70, 916, 40, BF16, True, False),            # 8 k-tiles, 6 stages
    ("persistent-tiles", 300, 300, 260, F32, True, False),  # 9 tiles on 3 emulated SMs
]


@pytest.mark.parametrize("name,M,K,N,dtype,bias,strided", GEMM_CASES,
                         ids=[c[0] for c in GEMM_CASES])
def test_emulated_int8_gemm_matches_plain_and_jax(on_host, name, M, K, N, dtype, bias, strided):
    rng = np.random.RandomState(M + K + N)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(N, K) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(N)).astype(np.float32) if bias else None
    xq, sx = _quantize(torch.from_numpy(x))
    wq, sw = _quantize(torch.from_numpy(w))
    if strided:  # columns 5 .. 5 + N of a wider buffer: odd stride, no pair stores
        wide = torch.full((M, N + 11), -7.0, dtype=dtype)
        out = wide[:, 5:5 + N]
    else:
        out = torch.empty(M, N, dtype=dtype)
    bt = None if b is None else torch.from_numpy(b)
    port_int8._launch_gemm(xq[:, :K], sx, wq[:, :K], sw, bt, out)
    if strided:
        assert (wide[:, :5] == -7).all() and (wide[:, 5 + N:] == -7).all()
    plain = port_int8.int8_dense_plain(torch.from_numpy(x), torch.from_numpy(w), bt, dtype)
    np.testing.assert_array_equal(out.float().numpy(), plain.float().numpy())
    want = np.asarray(jax_int8_dense(
        jnp.asarray(x), jnp.asarray(w.T), None if b is None else jnp.asarray(b),
        out_dtype=jnp.dtype(str(dtype)[6:])).astype(jnp.float32))
    got = out.float().numpy()
    if dtype == F32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:  # one bf16 ulp of each element
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


GATELOOP_CASES = [
    # name, B, L, D
    ("small", 2, 37, 5),
    ("two-blocks-unrolled-tail", 3, 21, 130),
    ("one-step", 2, 1, 7),
    ("below-a-chunk", 2, 5, 40),
    ("one-chunk", 2, 16, 40),
    ("a-chunk-and-a-step", 2, 17, 40),
    ("more-chunks-than-warps", 1, 300, 5),  # 19 chunks, 16 warps
    ("five-segments", 1, 1100, 5),  # 69 chunks, 16 a segment
]


@pytest.mark.parametrize("name,B,L,D", GATELOOP_CASES, ids=[c[0] for c in GATELOOP_CASES])
def test_emulated_gate_loop_matches_plain_and_jax(on_host, name, B, L, D):
    rng = np.random.RandomState(B * L * D)
    qkva = rng.randn(B, L, 3 * D).astype(np.float32)
    t = torch.from_numpy(qkva)
    q, kv, g = t.chunk(3, dim=-1)  # strided thirds, as the regressor hands them in
    a = torch.sigmoid(g)
    got = port_gateloop._launch(q, kv, a)
    plain = port_gateloop.gate_loop_operator_plain(q, kv, a)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    want = np.asarray(jax_gate_loop(*(jnp.asarray(v.contiguous().numpy()) for v in (q, kv, a))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GATELOOP_RTOL * np.abs(want).max())
