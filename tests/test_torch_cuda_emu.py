"""The kernels' CUDA sources, run on the CPU.

A CUDA kernel has no interpret mode, so the tests of ``test_torch_kernels.py``
reach only the plain versions. Here every source of
``sylber_tpu_torch/csrc`` (``smallattn.cu`` and ``flash.cu`` with
``attn_tile.cuh``, ``segment_scan.cu``, ``frontend.cu``, ``kmeanspp.cu``) is
compiled by g++ against the host stand-in of ``tests/cuda_emu``
(:func:`build_host_library`, once per hash of the sources under
``build/cuda_emu``): every CUDA thread is a fiber on the launching host
thread, and the PTX helpers of the headers (cp.async, ldmatrix, mma.sync,
the bulk copy with its mbarrier, the approximate reciprocal and square
root, the flag words of a cooperative launch) are replaced by emulations
written after the PTX ISA. The wrappers' own launch code
(``ops/_attn_launch.py``, ``ops/frontend.py``: scratch, strides, output
layout) then drives the emulated kernels on CPU tensors. The same numpy
inputs go through the JAX package (Pallas kernels in interpret mode) and
the emulated kernels are held against those and against the port's plain
versions at the tolerances the card is held to (attention fp32 2e-5, bf16
2e-2; conv0 2e-4). The segmentation kernels' cases are in
``test_torch_cuda_emu_segment.py`` (segments exactly equal) and
``test_torch_cuda_emu_pass2.py``, the seeding kernel's in
``test_torch_cuda_emu_kmeanspp.py``, the int8 and GateLoop sources' in
``test_torch_cuda_emu_int8.py``: separate files, so that a distributed run
spreads them over its workers.

This finds faults of indexing, masking, strides, padding and pipeline order.
A missing barrier shows where one thread reads what another wrote before
its next wait: the fibers switch only where a thread waits, in ascending
order in one block and descending in the next, so either direction is
caught, but not a race within a stretch between waits, as a GPU's warps,
which interleave at any instruction, could show. It cannot find a PTX
fault, a race of asynchronous copies or what the GPU's compiler makes of
the fast-math intrinsics; ``chip_smoke.py`` holds the real kernels on the
card.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops.pallas import flash as jax_flash
from sylber_tpu.ops.pallas.frontend import fused_conv0_gn_gelu
from sylber_tpu.ops.pallas.smallattn import fused_attention_small
from sylber_tpu_torch.kernels import _build
from sylber_tpu_torch.ops import _attn_launch
from sylber_tpu_torch.ops import frontend as port_frontend
from sylber_tpu_torch.ops.flash import flash_attention_plain
from sylber_tpu_torch.ops.smallattn import _dtype_scale, small_attention_plain
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

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


# the host libraries, one a hash of their sources (``build/`` is not committed)
HOST_BUILDS = Path(__file__).resolve().parents[1] / "build" / "cuda_emu"


def build_host_library(out: Path, names=SOURCES, entry_points=_ENTRY_POINTS):
    """The kernel sources ``names`` built for the host, with the C entry
    points typed; skips the test where there is no g++. The sources g++ takes
    are written to ``out``; the library is built once per hash of them, the
    stand-in's files and the command, under ``build/cuda_emu/<hash>`` (a file
    lock makes other processes wait for a build under way, then load it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host stand-in of the CUDA kernels")
    flags = ["-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas"]
    sources = _host_sources(out, names)
    digest = hashlib.sha256("\0".join([gxx, *flags, *names]).encode())
    for f in sorted(out.iterdir()) + sorted(EMU.iterdir()):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    final = HOST_BUILDS / digest.hexdigest()[:24]
    lib = final / "libkernels_host.so"
    HOST_BUILDS.mkdir(parents=True, exist_ok=True)
    with open(HOST_BUILDS / f"{final.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = HOST_BUILDS / f"{final.name}.{os.getpid()}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.copytree(out, tmp)
            cmd = [gxx, *flags, f"-I{EMU}", f"-I{tmp}", "-o", str(tmp / lib.name),
                   str(EMU / "emu.cpp"), *(str(tmp / f.name) for f in sources)]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
            assert done.returncode == 0, done.stderr[-4000:]
            os.replace(tmp, final)
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



# ---------------------------------------------------------------- segmentation helpers

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
