"""Build the CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), then linked into one shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. The entry points have a
plain C interface: pointers and the CUDA stream travel as ``c_void_p``,
sizes as ``c_int``, and each returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing here runs when the package is imported; the first wrapper that
launches a kernel calls :func:`lib`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)  # element strides, an array on the host
# entry point -> (argtypes, restype)
_SIGNATURES = {
    "sylber_cuda_error_string": ([_I], ctypes.c_char_p),
    "sylber_conv0_partials_size": ([_I, _I, _I, _I], _I),
    "sylber_conv0_gn_gelu": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _I, _P], _I),
    "sylber_small_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _S, _F,
                                _I, _P], _I),
    "sylber_flash_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _S, _F,
                                _I, _P], _I),
    "sylber_segment_pass1": ([_P] * 10 + [_I, _I, _I, _F, _P, _P], _I),
    "sylber_shared_divisor": ([_P] * 4 + [_I, _P], _I),
    "sylber_segment_pass2": ([_P] * 12 + [_I, _I, _I, _F, _P, _P], _I),
    "sylber_kmeanspp_blocks": ([_I], _I),
    "sylber_kmeanspp": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "sylber_quantize_rows": ([_P, _P, _P, _I, _I, _L, _I, _I, _I, _P], _I),
    "sylber_int8_gemm": ([_P] * 6 + [_I, _I, _I, _I, _I, _L, _I, _P], _I),
    "sylber_gate_loop": ([_P] * 4 + [_I, _I, _I, _S, _P], _I),
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of sylber_tpu_torch are built on the machine with the GPU")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if needed; return the shared library's path.

    The compiler's output, ``-Xptxas -v`` register and shared-memory counts
    included, is kept in ``build.log`` beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libsylber_kernels_{_digest()}.so"
    if so.exists():
        return so
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        nvcc = _nvcc()
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}.{so.stem}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp, so)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                               + "\n".join(log))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = args, res
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib().sylber_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
