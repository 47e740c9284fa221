"""The kernels' CUDA sources, run on the CPU.

A CUDA kernel has no interpret mode, so the tests of ``test_torch_kernels.py``
reach only the plain versions. Here every source of
``sylber_tpu_torch/csrc`` (``smallattn.cu`` and ``flash.cu`` with
``attn_tile.cuh``, ``segment_scan.cu``, ``frontend.cu``, ``kmeanspp.cu``) is
compiled by g++
against the host stand-in of ``tests/cuda_emu``: every CUDA thread is a host
thread, and the PTX helpers of the headers (cp.async, ldmatrix, mma.sync, the
bulk copy with its mbarrier, the approximate reciprocal and square root, the
flag words of a cooperative launch) are replaced by emulations written after
the PTX ISA. The wrappers' own launch
code (``ops/_attn_launch.py``, ``ops/segment.py``, ``ops/frontend.py``,
``flow/kmeans.py``: scratch, strides, output layout) then drives the
emulated kernels on CPU tensors. The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode, ``segment_batch``, the numpy oracle), and the emulated
kernels are held against those and against the port's plain versions at the
tolerances the card is held to (attention fp32 2e-5, bf16 2e-2; conv0 2e-4;
segments exactly equal).

This finds faults of indexing, masking, strides, padding and pipeline order.
It cannot find a PTX fault, a race (of asynchronous copies, or between
threads where a barrier is missing: the host threads of a block rarely
interleave as a GPU's warps do) or what the GPU's compiler makes of the
fast-math intrinsics; ``chip_smoke.py`` holds the real kernels on the card.
"""

import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops import segment as jax_segment
from sylber_tpu.ops.pallas import flash as jax_flash
from sylber_tpu.ops.pallas.frontend import fused_conv0_gn_gelu
from sylber_tpu.ops.pallas.smallattn import fused_attention_small
from sylber_tpu.ops.segment_np import segment_oracle
from sylber_tpu_torch.flow import kmeans as port_kmeans
from sylber_tpu_torch.kernels import _build
from sylber_tpu_torch.ops import _attn_launch
from sylber_tpu_torch.ops import frontend as port_frontend
from sylber_tpu_torch.ops import segment as port_segment
from sylber_tpu_torch.ops.flash import flash_attention_plain
from sylber_tpu_torch.ops.smallattn import _dtype_scale, small_attention_plain

EMU = Path(__file__).parent / "cuda_emu"
# helpers whose bodies are PTX: emu.cpp defines them instead
_PTX_HELPERS = {
    "attn_tile.cuh": ["cp_async16", "cp_async_commit", "cp_async_wait", "ldmatrix_x4_trans",
                      "ldmatrix_x4", "mma_bf16", "fast_exp2"],
    "common.cuh": ["ex2_approx", "rcp_approx", "mbar_init", "fence_mbar_init", "mbar_expect_tx",
                   "mbar_arrive", "bulk_copy_to_shared", "mbar_wait", "rsqrt_approx", "flag_store",
                   "flag_load"],
    "int8_gemm.cu": ["smem_addr", "tma_load_2d", "wgmma_fence", "wgmma_commit", "wgmma_wait",
                     "wgmma_s8"],
}
_DECLARATIONS = {
    "attn_tile.cuh": ("struct Args {", """
void cp_async16(void* dst, const void* src, int bytes); void cp_async_commit();
template <int N> void cp_async_wait() {}
void ldmatrix_x4(uint32_t (&r)[4], const void* p);
void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p);
void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
float fast_exp2(float x);
"""),
    "int8_gemm.cu": ("// Shared-memory helpers of the GEMM", """
uint32_t smem_addr(const void* p);
void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar);
inline void wgmma_fence() {}
inline void wgmma_commit() {}
// wgmma's .sync.aligned: the whole warp has issued before any lane goes on
template <int N> void wgmma_wait() { __syncwarp(); }
void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db);
"""),
    "common.cuh": ("constexpr int MAX_COUNT", """
inline float ex2_approx(float x) { return exp2f(x); }
inline float rcp_approx(float x) { return 1.f / x; }
inline float rsqrt_approx(float x) { return 1.f / sqrtf(x); }
// mbarriers and the bulk copy, emulated in emu.cpp: a copy lands at once; a
// wait spins until other host threads have completed the phase
void mbar_init(uint64_t* bar, int count);
inline void fence_mbar_init() {}
void mbar_expect_tx(uint64_t* bar, unsigned bytes);
void mbar_arrive(uint64_t* bar);
void bulk_copy_to_shared(void* dst, const void* src, unsigned bytes, uint64_t* bar);
void mbar_wait(uint64_t* bar, int parity);
// the flag words, emulated in emu.cpp: whole 8-byte words, a wait that yields
// and aborts after two minutes
void flag_store(unsigned long long* word, unsigned value, unsigned step);
unsigned flag_load(const unsigned long long* word, unsigned step);
"""),
}
_ENTRY_POINTS = ["sylber_small_attention", "sylber_flash_attention", "sylber_segment_pass1",
                 "sylber_segment_pass2", "sylber_shared_divisor", "sylber_conv0_partials_size",
                 "sylber_conv0_gn_gelu", "sylber_kmeanspp_scratch", "sylber_kmeanspp",
                 "sylber_kmeanspp_barrier_probe"]


SOURCES = ("common.cuh", "attn_tile.cuh", "smallattn.cu", "flash.cu", "segment_scan.cu",
           "frontend.cu", "kmeanspp.cu")


def _host_sources(out: Path, names=SOURCES) -> list:
    """Copies of the kernel sources ``names`` that g++ takes: the PTX helpers
    renamed away, ``<<<...>>>`` launches turned into calls of ``emu_launch``
    and cooperative launches into the stand-in's typed
    ``cudaLaunchCooperativeKernel``, and the ``__shared__`` arrays inside
    kernels made static (one copy for the block's host threads; the attention
    kernels' dynamic array is defined in emu.cpp, the seeding kernel's is
    each emulated block's own)."""
    sources = []
    for src in (_build.CSRC / n for n in names):
        text = src.read_text()
        for name in _PTX_HELPERS.get(src.name, ()):
            text, n = re.subn(r"(__device__ __forceinline__ \w+ )" + name + r"\(",
                              r"\1ptx_" + name + "(", text, count=1)
            assert n == 1, f"helper {name} not found in {src.name}"
        if src.name in _DECLARATIONS:
            anchor, decl = _DECLARATIONS[src.name]
            assert anchor in text, f"{anchor!r} not found in {src.name}"
            text = text.replace(anchor, decl + anchor, 1)
        if src.name in ("segment_scan.cu", "frontend.cu", "kmeanspp.cu", "int8_gemm.cu",
                        "gateloop.cu"):
            text = text.replace("extern __shared__ __align__(128) float ring[];",
                                "static __align__(128) float ring[RING * MAX_DIM];")
            text = text.replace("extern __shared__ __align__(1024) int8_t gemm_smem[];",
                                "int8_t* const gemm_smem = (int8_t*)::sylber::attn::smem_raw;")
            text = text.replace("extern __shared__ __align__(16) unsigned char seed_smem[];",
                                "unsigned char* const seed_smem = emu_dynamic_smem();")
            text = text.replace("cudaLaunchCooperativeKernel((const void*)",
                                "cudaLaunchCooperativeKernel(")
            text = text.replace("__shared__", "static")
        text = re.sub(r"\b(\w+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                      r"emu_launch([&] { \1(\3); }, \2);", text, flags=re.S)
        assert "<<<" not in text, f"a launch of {src.name} was not rewritten"
        dst = out / (src.stem + ".cpp" if src.suffix == ".cu" else src.name)
        dst.write_text(text)
        if src.suffix == ".cu":
            sources.append(dst)
    return sources


def build_host_library(out: Path, names=SOURCES, entry_points=_ENTRY_POINTS):
    """The kernel sources ``names`` built for the host in ``out``, with the C
    entry points typed; skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host stand-in of the CUDA kernels")
    lib = out / "libkernels_host.so"
    cmd = [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", f"-I{out}",
           "-Wno-unknown-pragmas", "-o", str(lib), str(EMU / "emu.cpp"),
           *map(str, _host_sources(out, names))]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    for name in entry_points:
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return handle


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, with the C entry points typed."""
    return build_host_library(tmp_path_factory.mktemp("cuda_emu"))


def _check(code, name):
    assert code == 0, f"{name}: the entry point returned {code}"


@pytest.fixture
def launch(emulated, monkeypatch):
    """``launch_attention`` as the wrappers call it, bound to the host library."""
    monkeypatch.setattr(_attn_launch, "lib", lambda: emulated)
    monkeypatch.setattr(_attn_launch, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_attn_launch, "stream_of", lambda t: 0)
    monkeypatch.setattr(_attn_launch, "check", _check)
    return _attn_launch.launch_attention


@pytest.fixture
def flash_interpret(monkeypatch):
    """Run the JAX flash kernel's pallas_call in interpret mode."""
    orig = jax_flash.pl.pallas_call
    monkeypatch.setattr(jax_flash.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    jax_flash._flash._clear_cache()
    yield
    jax_flash._flash._clear_cache()


F32, BF16 = torch.float32, torch.bfloat16
CASES = [
    # kernel, L, D, dtype, kv_len, scale, strided (B, L, H, D) views
    ("small", 77, 64, BF16, [0, 1, 63, 64, 77], None, True),
    ("small", 250, 64, BF16, [250, 129], None, False),           # 4 key tiles
    ("small", 77, 12, BF16, [0, 1, 76, 77], None, False),        # scalar loads
    ("small", 130, 128, BF16, [65, 130], None, False),           # one slab a warp
    ("small", 1, 32, BF16, [1], None, False),
    ("small", 77, 64, F32, [0, 1, 63, 64, 77], None, True),
    ("small", 140, 12, F32, [129, 0], None, False),
    ("small", 130, 128, F32, [65, 130], None, False),
    ("flash", 300, 64, BF16, [300, 191, 0], 0.3, True),          # the ring wraps
    ("flash", 200, 32, BF16, [64, 128, 200], None, True),
    ("flash", 150, 12, BF16, [0, 1, 149, 150], 0.3, False),
    ("flash", 300, 64, F32, [300, 191, 0], 0.3, False),
    ("flash", 150, 12, F32, [0, 1, 149, 150], None, True),
    # q, k, v as views of one fused (B, L, 3, H, D) projection
    ("small", 77, 64, BF16, [0, 1, 63, 64, 77], None, "fused"),
    ("flash", 300, 64, F32, [300, 191, 0], 0.3, "fused"),
]


def _tensors(arrays, dtype, strided):
    """(B, H, L, D) tensors, as views of (B, L, H, D) memory where ``strided``,
    of one (B, L, 3, H, D) buffer where it is ``"fused"``."""
    out = [torch.from_numpy(a).to(dtype) for a in arrays]
    if strided == "fused":
        fused = torch.stack([t.transpose(1, 2) for t in out], dim=2)
        return [fused[:, :, i].transpose(1, 2) for i in range(3)]
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in out] if strided else out


@pytest.mark.parametrize(
    "kind,L,D,dtype,lens,scale,strided", CASES,
    ids=[f"{c[0]}-L{c[1]}-D{c[2]}-{str(c[3])[6:]}" + ("-fused" if c[6] == "fused" else "")
         for c in CASES])
def test_emulated_kernel_matches_plain(launch, flash_interpret, kind, L, D, dtype, lens,
                                       scale, strided):
    """The emulated kernel against the JAX kernel (Pallas interpret mode) and
    against the port's plain version, all on the same numpy inputs."""
    B, H = len(lens), 2
    rng = np.random.RandomState(100 * L + D)
    arrays = [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]
    q, k, v = _tensors(arrays, dtype, strided)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(str(dtype)[6:])) for a in arrays)
    s = D ** -0.5 if scale is None else scale
    if kind == "small":
        got = launch("sylber_small_attention", "small_attention", q, k, v, kv_len,
                     _dtype_scale(s, dtype), 512, 128)
        plain = small_attention_plain(q, k, v, kv_len, scale)
        jax_out = fused_attention_small(jq, jk, jv, kv_len=jnp.asarray(lens, jnp.int32),
                                        scale=scale, interpret=True)
    else:
        got = launch("sylber_flash_attention", "flash_attention", q, k, v, kv_len,
                     float(s), 2 ** 31 - 1, 128)
        plain = flash_attention_plain(q, k, v, kv_len, scale)
        valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]
        bias = np.where(valid, 0.0, np.finfo(np.float32).min)[:, None, None, :]
        jax_out = jax_flash.flash_attention(jq, jk, jv, bias=jnp.asarray(bias, jnp.float32),
                                            scale=scale)
    assert got.shape == plain.shape and got.dtype == dtype
    if L > 1:  # the output is laid out as q is
        assert got.transpose(1, 2).is_contiguous() == bool(strided)
    tol = 2e-5 if dtype == F32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_out, np.float32),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------- segmentation

@pytest.mark.parametrize("divisors", ["frame counts"])
def test_shared_divisor_division_is_the_ieee_division(emulated, divisors):
    """``Divisor`` of ``common.cuh`` (one reciprocal, then estimate, remainder
    and correction per numerator) gives the bits of ``x / c`` for the frame
    counts the scan divides by, as ``(curr * cnt + x) / (cnt + 1)`` needs.
    The GPU's reciprocal seed is emulated by a rounded ``1 / c``, so this holds
    the steps after the seed; ``chip_smoke.py`` checks the real one."""
    rng = np.random.RandomState(0)
    c = np.concatenate([np.arange(1, 4002), rng.randint(1, 4002, 40000)]).astype(np.float32)
    x = (rng.randn(c.size) * np.exp(rng.uniform(-12, 8, c.size))).astype(np.float32)
    q, r = np.empty_like(x), np.empty_like(x)
    _check(emulated.sylber_shared_divisor(x.ctypes.data, c.ctypes.data, q.ctypes.data,
                                          r.ctypes.data, c.size, 0), "shared_divisor")
    np.testing.assert_array_equal(r.view(np.int32), (np.float32(1) / c).view(np.int32))
    np.testing.assert_array_equal(q.view(np.int32), (x / c).view(np.int32))


@pytest.fixture
def segment_launch(emulated, monkeypatch):
    """The launch halves of ``ops/segment.py``'s wrappers on the host library."""
    monkeypatch.setattr(port_segment, "lib", lambda: emulated)
    monkeypatch.setattr(port_segment, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_segment, "check", _check)
    return port_segment._launch_pass1, port_segment._launch_pass2


def _plateaus(rng, L, d):
    """Syllable-like plateaus separated by low-norm gaps, (L, d)."""
    out = np.zeros((L, d), np.float32)
    i = 0
    while i < L:
        span = min(int(rng.randint(2, 14)), L - i)
        if rng.rand() < 0.25:
            out[i:i + span] = rng.randn(span, d) * 0.05
        else:
            proto = rng.randn(d)
            proto *= rng.uniform(4.0, 9.0) / np.linalg.norm(proto)
            out[i:i + span] = proto + rng.randn(span, d) * 0.15
        i += span
    return out


def _quirk_rows(rng):
    """The count-carry quirk row, an all-silent row, and a row whose every
    frame is a boundary (independent directions), (3, 12, 16)."""
    d = 16
    a, b = rng.randn(d), rng.randn(d)
    a, b = a / np.linalg.norm(a) * 5, b / np.linalg.norm(b) * 5
    quirk = np.stack([a] * 6 + [b] + [0.7 * a + 0.3 * b] * 5)
    every = np.eye(12, d) * 5 + 0.01 * rng.randn(12, d)
    return np.stack([quirk, np.zeros_like(quirk), every]).astype(np.float32)


SEGMENT_CASES = [
    # name, seed, L, d, valid lengths
    ("d144", 0, 150, 144, [150, 97, 5]),
    ("d144-ring-wraps", 9, 260, 144, [260, 131]),       # 8 blocks of 32 frames, 8 ring turns
    ("d768-L50", 1, 50, 768, [50, 19]),
    ("d768-L90", 1, 90, 768, [90, 61]),
    ("d768-padded", 2, 90, 768, [90, 33]),
    ("d768-L70", 5, 70, 768, [70, 70]),
    ("d50-scalar-copies", 3, 100, 50, [100, 100, 42]),
    ("d1024", 4, 40, 1024, [40]),                       # three chunks a thread
    ("d384-one-chunk-a-thread", 6, 40, 384, [40, 40]),  # the widest frame of one chunk
    ("d388-two-chunks-a-thread", 6, 40, 388, [40, 23]),
    ("quirk-empty-every-frame", 7, 12, 16, [12, 12, 12]),
    ("one-frame", 8, 1, 144, [1, 0]),
    ("one-long-plateau", 10, 200, 144, [200, 200]),     # the merged mean at counts up to 200
]


@pytest.mark.parametrize("name,seed,L,d,lens", SEGMENT_CASES,
                         ids=[c[0] for c in SEGMENT_CASES])
def test_emulated_segmentation_matches_oracle_and_jax(segment_launch, name, seed, L, d, lens):
    """Both segmentation kernels against their plain versions (events, buffers,
    segments and counts exactly), the numpy oracle and the JAX ``segment_batch``."""
    launch_pass1, launch_pass2 = segment_launch
    rng = np.random.RandomState(seed)
    if name.startswith("quirk"):
        states, nt, mt = _quirk_rows(rng), 1.0, 0.8
    elif name == "one-long-plateau":  # every frame voiced, nearly all merge
        proto = rng.randn(len(lens), 1, d) * 0.5
        states = (proto + rng.randn(len(lens), L, d) * 0.15).astype(np.float32)
        nt, mt = 1.0, 0.85
    else:
        states = np.stack([_plateaus(rng, L, d) for _ in lens])
        nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.6, 0.95))
    valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]

    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = ((norms >= nt) & torch.from_numpy(valid)).contiguous()
    P = port_segment._prefix_sums(x)
    got1 = launch_pass1(x, voiced, mt)
    want1 = port_segment.segment_pass1_plain(x, voiced, mt)
    for field, g, w in zip(got1._fields, got1, want1):
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    if name.startswith("quirk"):
        assert got1.nseg.tolist()[1:] == [0, 12] and got1.nmid.tolist()[1:] == [0, 11]

    segs, n = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, mt)
    want_segs, want_n = port_segment.segment_pass2_plain(
        x, norms, P, want1.segs, want1.nseg, want1.mids, want1.nmid, mt)
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    np.testing.assert_array_equal(segs.numpy(), want_segs.numpy())
    ref = jax_segment.segment_batch(jnp.asarray(states), nt, mt, frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref.num_segments))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref.segments))
    for b, length in enumerate(lens):
        oracle = segment_oracle(states[b, :length], nt, mt)
        assert segs[b, :int(n[b])].numpy().tolist() == oracle.tolist()


@pytest.mark.parametrize("second,above", [((1, 2), False), ((1, 4), True)],
                         ids=["on-the-threshold", "one-ulp-above"])
def test_emulated_pass1_decides_a_cosine_at_the_threshold_exactly(segment_launch, second, above):
    """The scan kernel decides from an estimate of the cosine unless the
    estimate is within 1e-5 of the threshold; there the IEEE quotient must
    decide. Frames of small integers make every sum exact in any order, so
    the cosine of frames 0 and 1 is the same float everywhere: with the
    threshold on it the frames merge (``>=``), one ulp above they do not.
    With (1, 1) and (1, 2) the estimate lies below the quotient, with (1, 1)
    and (1, 4) an ulp above it, so the estimate alone would decide wrongly."""
    launch_pass1, _ = segment_launch
    states = np.zeros((1, 6, 8), np.float32)
    states[0, :, :2] = [(1, 1), second] * 3
    eps = np.float32(1e-8)
    dot, xx = np.float32(1 + second[1]), np.float32(1 + second[1] ** 2)
    cosine = dot / np.sqrt(np.float32(2) + eps) / np.sqrt(xx + eps)
    estimate = (dot * (np.float32(1) / np.sqrt(xx + eps))) * (
        np.float32(1) / np.sqrt(np.float32(2) + eps))
    thr = np.nextafter(cosine, np.float32(2)) if above else cosine
    assert (estimate >= thr) != (cosine >= thr)  # the estimate alone is wrong here
    x = torch.from_numpy(states)
    voiced = torch.ones(1, 6, dtype=torch.bool)
    got = launch_pass1(x, voiced, float(thr))
    want = port_segment.segment_pass1_plain(x, voiced, float(thr))
    for field, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    assert bool(got.boundary[0, 1]) == above


THRESHOLD_CASES = [c for c in SEGMENT_CASES if c[0] in ("d768-L50", "one-frame")]


@pytest.mark.parametrize("name,seed,L,d,lens", THRESHOLD_CASES, ids=[c[0] for c in THRESHOLD_CASES])
def test_emulated_segmentation_reads_the_threshold_from_memory(segment_launch, name, seed, L,
                                                               d, lens):
    """Both kernels given the merge threshold as a pointer to one float32 (a
    0-d tensor on the states' device, as the trainer passes it) against the
    same kernels given the number, the plain versions and JAX's
    ``segment_batch``: the same events, buffers and segments, bit for bit,
    for a threshold that float32 does not hold exactly."""
    launch_pass1, launch_pass2 = segment_launch
    rng = np.random.RandomState(seed)
    states = np.stack([_plateaus(rng, L, d) for _ in lens])
    nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.6, 0.95)) + 1e-12
    valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = ((norms >= nt) & torch.from_numpy(valid)).contiguous()
    P = port_segment._prefix_sums(x)
    thr = torch.tensor(mt, dtype=torch.float32)
    assert port_segment.kernel_threshold("t", thr, x) == (0.0, thr.data_ptr())
    got1, num1 = launch_pass1(x, voiced, thr), launch_pass1(x, voiced, mt)
    want1 = port_segment.segment_pass1_plain(x, voiced, thr)
    for field, g, n, w in zip(got1._fields, got1, num1, want1):
        np.testing.assert_array_equal(g.int().numpy(), n.int().numpy(), err_msg=field)
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    segs, n = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, thr)
    segs_num, n_num = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, mt)
    want_segs, want_n = port_segment.segment_pass2_plain(
        x, norms, P, want1.segs, want1.nseg, want1.mids, want1.nmid, thr)
    for a in (segs_num, want_segs):
        np.testing.assert_array_equal(segs.numpy(), a.numpy())
    for a in (n_num, want_n):
        np.testing.assert_array_equal(n.numpy(), a.numpy())
    ref = jax_segment.segment_batch(jnp.asarray(states), nt, mt, frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref.segments))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref.num_segments))


# ---------------------------------------------------------------- conv0

@pytest.fixture
def conv0_launch(emulated, monkeypatch):
    """The launch half of ``ops/frontend.py``'s wrapper on the host library."""
    monkeypatch.setattr(port_frontend, "lib", lambda: emulated)
    monkeypatch.setattr(port_frontend, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_frontend, "check", _check)
    return port_frontend._launch


CONV0_CASES = [
    # name, samples, channels, first zero-padded sample of item 1, DC offset, output dtype
    ("plain", 22000, 72, None, 0.0, F32),       # 3 time tiles, 2 moment chunks, 64 + 8 channels
    ("padded-item", 6400, 32, 3000, 0.0, F32),
    ("dc-offset", 6400, 32, None, 0.5, F32),
    ("padded-dc-bf16", 6400, 32, 3000, 0.5, BF16),
    ("one-frame", 13, 8, None, 0.0, F32),
]


@pytest.mark.parametrize("name,L,D,pad_from,dc,dtype", CONV0_CASES,
                         ids=[c[0] for c in CONV0_CASES])
def test_emulated_conv0_matches_pallas(conv0_launch, name, L, D, pad_from, dc, dtype):
    """The three conv0 kernels (moments from the waveform, fold, normalise)
    against the JAX kernel in interpret mode and the plain version."""
    rng = np.random.RandomState(L + D)
    x = (rng.randn(2, L) + dc).astype(np.float32)
    if pad_from is not None:
        x[1, pad_from:] = 0.0
    w = (rng.randn(10, 1, D) / np.sqrt(10)).astype(np.float32)  # flax layout
    gamma = rng.uniform(0.5, 1.5, D).astype(np.float32)
    beta = (0.1 * rng.randn(D)).astype(np.float32)
    tw = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 1, 0))))
    T0 = (L - 10) // 5 + 1
    got = conv0_launch(torch.from_numpy(x), tw, torch.from_numpy(gamma),
                       torch.from_numpy(beta), T0, 1e-5, dtype)
    assert got.shape == (2, D, T0) and got.dtype == dtype
    tol = 2e-4 if dtype == F32 else 2e-2
    plain = port_frontend.conv0_gn_gelu_plain(torch.from_numpy(x), tw, torch.from_numpy(gamma),
                                              torch.from_numpy(beta), out_dtype=dtype)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    want = np.asarray(fused_conv0_gn_gelu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta),
        interpret=True))
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1), want,
                               rtol=tol, atol=tol)


OTHER_TAPS = [
    # name, taps, stride, samples, channels, first zero-padded sample of item 1, dtype
    ("k8-s4", 8, 4, 9000, 72, None, F32),        # 3 tiles of 1,024 frames, 64 + 8 channels
    ("k6-s3-padded-bf16", 6, 3, 4000, 32, 1500, BF16),
    ("k8-s4-one-frame", 8, 4, 12, 8, None, F32),  # 12 samples: k + s, two frames
    ("k13-s7", 13, 7, 5000, 40, None, F32),       # taps padded to 16, 2 frames a thread
    ("k20-s10-bf16", 20, 10, 5000, 24, 2600, BF16),  # past the Pallas kernel's 2s <= 16
]


@pytest.mark.parametrize("name,k,s,L,D,pad_from,dtype", OTHER_TAPS, ids=[c[0] for c in OTHER_TAPS])
def test_emulated_conv0_other_taps_matches_plain(conv0_launch, name, k, s, L, D, pad_from,
                                                 dtype):
    """The runtime-shaped conv0 kernels (any k <= 2s; here (8, 4), (6, 3),
    (13, 7) and (20, 10)) against the plain version at that stride and,
    within its domain (k <= 2s <= 16), the JAX kernel in interpret mode, at
    conv0's tolerances (2e-4 fp32, 2e-2 bf16)."""
    rng = np.random.RandomState(L + D + k)
    x = rng.randn(2, L).astype(np.float32)
    if pad_from is not None:
        x[1, pad_from:] = 0.0
    w = (rng.randn(k, 1, D) / np.sqrt(k)).astype(np.float32)  # flax layout
    gamma = rng.uniform(0.5, 1.5, D).astype(np.float32)
    beta = (0.1 * rng.randn(D)).astype(np.float32)
    tw = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 1, 0))))
    T0 = (L - k) // s + 1
    args = (torch.from_numpy(x), tw, torch.from_numpy(gamma), torch.from_numpy(beta))
    got = conv0_launch(*args, T0, 1e-5, dtype, s)
    assert got.shape == (2, D, T0) and got.dtype == dtype
    tol = 2e-4 if dtype == F32 else 2e-2
    plain = port_frontend.conv0_gn_gelu_plain(*args, stride=s, out_dtype=dtype)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    if 2 * s > 16:  # the Pallas kernel pads a patch of 2s samples to 16 lanes
        return
    want = np.asarray(fused_conv0_gn_gelu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta),
        stride=s, kernel_size=k, interpret=True))
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- k-means++ seeding

@pytest.fixture
def kmeanspp_launch(emulated, monkeypatch):
    """``flow/kmeans.py``'s launch code, bound to the host library."""
    monkeypatch.setattr(port_kmeans, "lib", lambda: emulated)
    monkeypatch.setattr(port_kmeans, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_kmeans, "check", _check)
    return port_kmeans._launch


KMEANSPP_CASES = [
    # name, rows, width, centers, distinct points (each repeated) or None, resident rows a
    # block (-1: all that fit), the fewest rows a block, a block's most threads; on the
    # stand-in's card of 3 SMs
    ("two-blocks", 128, 24, 24, None, -1, 64, 64),      # float4 loads, a grid of 2 blocks
    ("scalar-width", 128, 5, 16, None, -1, 64, 64),     # d % 4 != 0: rows padded in shared memory
    ("awkward-rows", 150, 144, 12, None, -1, 64, 128),  # 3 blocks of 50 rows
    ("duplicates", 128, 8, 16, 16, -1, 64, 64),         # 16 distinct points, 8 copies each
    ("partly-resident", 150, 24, 16, None, 20, 64, 64),    # 20 of a block's 50 rows resident
    ("none-resident-scalar", 128, 5, 16, None, 0, 64, 32),  # every row from memory, one warp
    ("d768-partly-resident", 96, 768, 8, None, 12, 32, 64),  # 3 blocks of 32 rows, 12 resident
    ("d768-resident", 96, 768, 8, None, -1, 32, 64),
    ("draw-in-last-block", 150, 24, 12, None, -1, 64, 64),  # the last block's rows far out
    ("grid-of-one", 20, 24, 20, None, -1, 64, 64),   # n below min_rows: one block, every row
    ("six-blocks", 384, 8, 12, None, -1, 64, 64),    # 2 blocks an SM: more blocks than SMs
]


@pytest.mark.parametrize("name,n,d,k,distinct,capacity,min_rows,max_threads", KMEANSPP_CASES,
                         ids=[c[0] for c in KMEANSPP_CASES])
def test_emulated_kmeanspp_matches_plain(kmeanspp_launch, emulated, name, n, d, k, distinct,
                                         capacity, min_rows, max_threads):
    """The seeding kernel (one cooperative launch: the distance update, the
    exchanges of flag words, the draw spread over the grid) against
    ``kmeanspp_plain`` on the same uniforms: the same rows and centers
    exactly (a row may differ only where the uniform lands within float64
    rounding of a prefix boundary; none does here), twice with the same rows,
    wholly and partly resident; on a pool of k distinct points each
    repeated, every distinct point once."""
    rng = np.random.RandomState(n + d + k)
    if distinct:
        pts = rng.randn(distinct, d).astype(np.float32)
        x = torch.from_numpy(pts[rng.permutation(np.repeat(np.arange(distinct), n // distinct))])
    else:
        x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    plan = (ctypes.c_int * 6)()
    assert emulated.sylber_kmeanspp_scratch(n, d, min_rows, max_threads, capacity, plan) > 0
    grid, rows_per_block, resident = plan[0], plan[1], plan[2]
    if name == "draw-in-last-block":
        x[(grid - 1) * rows_per_block:] *= 20
    u = port_kmeans.seeding_uniforms(n + k, k)
    assert port_kmeans.lib is not _build.lib
    centers, rows = kmeanspp_launch(x, u, capacity, min_rows, max_threads)
    again_centers, again = kmeanspp_launch(x, u, capacity, min_rows, max_threads)
    want_centers, want_rows = port_kmeans.kmeanspp_plain(x, u)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    torch.testing.assert_close(centers, want_centers, rtol=0, atol=0)
    np.testing.assert_array_equal(again.numpy(), rows.numpy())
    torch.testing.assert_close(again_centers, centers, rtol=0, atol=0)
    expect = {"grid-of-one": 1, "six-blocks": 6, "awkward-rows": 3, "two-blocks": 2}
    assert grid == expect.get(name, grid)
    assert resident == (min(capacity, rows_per_block) if capacity >= 0 else rows_per_block)
    if name == "draw-in-last-block":
        assert (rows[1:] >= (grid - 1) * rows_per_block).sum() >= k // 2
    if name == "grid-of-one":
        assert sorted(rows.tolist()) == list(range(n))
    if distinct:
        assert len({tuple(r) for r in centers.numpy().tolist()}) == distinct


@pytest.mark.parametrize("n,d,min_rows,grid", [(150, 24, 64, 3), (384, 8, 64, 6)],
                         ids=["3-blocks", "6-blocks"])
def test_emulated_exchange_reaches_every_block(emulated, n, d, min_rows, grid):
    """The exchange probe on the seeding's grid: 40 steps of every block's
    flag words to every block end with every block's words of the last
    step written (a block that read a word before its step would have taken
    a stale value; one that waited for a step never written would abort the
    stand-in); a capacity past the card's shared memory is refused."""
    plan = (ctypes.c_int * 6)()
    size = emulated.sylber_kmeanspp_scratch(n, d, min_rows, 64, -1, plan)
    stride = -(-d // 4) * 4
    assert plan[0] == grid and size == 2 * (2 * grid + stride)
    scratch = np.zeros(size, np.uint64)
    _check(emulated.sylber_kmeanspp_barrier_probe(scratch.ctypes.data, n, d, min_rows, 64, 40,
                                                  None), "kmeanspp_barrier_probe")
    last = scratch[: 2 * grid]  # step 40's parity: 0
    assert ((last >> np.uint64(32)) == 40).all()
    assert (scratch[size // 2: size // 2 + 2 * grid] >> np.uint64(32) == 39).all()
    assert emulated.sylber_kmeanspp_scratch(n, d, min_rows, 64, 10 ** 6, None) == -1
