"""The attention kernels' CUDA sources, run on the CPU.

A CUDA kernel has no interpret mode, so the tests of ``test_torch_kernels.py``
reach only the plain versions. Here ``sylber_tpu_torch/csrc/smallattn.cu``
and ``flash.cu`` (with ``attn_tile.cuh``) are compiled by g++ against the
host stand-in of ``tests/cuda_emu``: every CUDA thread is a host thread, and
the PTX helpers of the header (cp.async, ldmatrix, mma.sync) are replaced by
emulations written after the PTX ISA's fragment layouts. The wrappers' own
launch code (``ops/_attn_launch.py``: checks, strides, output layout) then
drives the emulated kernels on CPU tensors. The same numpy inputs go through
the JAX package's Pallas kernels in interpret mode, and the emulated kernels
are held against those and against the port's plain versions at the
tolerances the card is held to (fp32 2e-5, bf16 2e-2).

This finds faults of indexing, masking, strides, padding and pipeline order
in both kernels (mma.sync in bf16, register-tiled in fp32). It cannot find a
PTX fault or a race of asynchronous copies; ``chip_smoke.py`` holds the real
kernels on the card.
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

from sylber_tpu.ops.pallas import flash as jax_flash
from sylber_tpu.ops.pallas.smallattn import fused_attention_small
from sylber_tpu_torch.kernels import _build
from sylber_tpu_torch.ops import _attn_launch
from sylber_tpu_torch.ops.flash import flash_attention_plain
from sylber_tpu_torch.ops.smallattn import _dtype_scale, small_attention_plain

EMU = Path(__file__).parent / "cuda_emu"
# helpers of attn_tile.cuh whose bodies are PTX: emu.cpp defines them instead
_PTX_HELPERS = ["cp_async16", "cp_async_commit", "cp_async_wait", "ldmatrix_x4_trans",
                "ldmatrix_x4", "mma_bf16", "fast_exp2"]
_DECLARATIONS = """
void cp_async16(void* dst, const void* src, int bytes); void cp_async_commit();
template <int N> void cp_async_wait() {}
void ldmatrix_x4(uint32_t (&r)[4], const void* p);
void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p);
void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
float fast_exp2(float x);
"""


def _host_sources(out: Path) -> list:
    """Copies of the attention sources that g++ takes: the PTX helpers renamed
    away, ``<<<...>>>`` launches turned into calls of ``emu_launch``."""
    sources = []
    for src in (_build.CSRC / n for n in ("common.cuh", "attn_tile.cuh", "smallattn.cu",
                                          "flash.cu")):
        text = src.read_text()
        if src.name == "attn_tile.cuh":
            for name in _PTX_HELPERS:
                text, n = re.subn(r"(__device__ __forceinline__ \w+ )" + name + r"\(",
                                  r"\1ptx_" + name + "(", text, count=1)
                assert n == 1, f"helper {name} not found in attn_tile.cuh"
            text = text.replace("struct Args {", _DECLARATIONS + "struct Args {", 1)
        text = re.sub(r"^(\s*)(\w+<[^;]*?>)<<<(.*?)>>>\((.*)\);",
                      r"\1emu_launch([&] { \2(\4); }, \3);", text, flags=re.M)
        dst = out / (src.stem + ".cpp" if src.suffix == ".cu" else src.name)
        dst.write_text(text)
        if src.suffix == ".cu":
            sources.append(dst)
    return sources


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, with the C entry points typed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host stand-in of the CUDA kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    lib = out / "libattn_host.so"
    cmd = [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}", f"-I{out}",
           "-Wno-unknown-pragmas", "-o", str(lib), str(EMU / "emu.cpp"),
           *map(str, _host_sources(out))]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    for name in ("sylber_small_attention", "sylber_flash_attention"):
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    return handle


@pytest.fixture
def launch(emulated, monkeypatch):
    """``launch_attention`` as the wrappers call it, bound to the host library."""
    def check(code, name):
        assert code == 0, f"{name}: the entry point returned {code}"

    monkeypatch.setattr(_attn_launch, "lib", lambda: emulated)
    monkeypatch.setattr(_attn_launch, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_attn_launch, "stream_of", lambda t: 0)
    monkeypatch.setattr(_attn_launch, "check", check)
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
]


def _tensors(arrays, dtype, strided):
    """(B, H, L, D) tensors, as views of (B, L, H, D) memory where ``strided``."""
    out = [torch.from_numpy(a).to(dtype) for a in arrays]
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in out] if strided else out


@pytest.mark.parametrize(
    "kind,L,D,dtype,lens,scale,strided", CASES,
    ids=[f"{c[0]}-L{c[1]}-D{c[2]}-{str(c[3])[6:]}" for c in CASES])
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
        assert got.transpose(1, 2).is_contiguous() == strided
    tol = 2e-5 if dtype == F32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_out, np.float32),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
