"""ctypes bindings for the port's native (C++) host components.

Port of ``sylber_tpu/utils/native.py``. Each library is built by the system
``g++`` at first use from the port's own source, ``native/<name>.cc``, into
``build/native/`` at the repository root (listed in ``.gitignore``). Its
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is; a file lock keeps two
processes from building the same library at once, as ``kernels/_build.py``
does for the CUDA kernels. Nothing is built when the module is imported.

- the segmenter (``segment.cc``): CPU-only preprocessing of a corpus
  (``precompute_segments --native``) and an independent oracle in the tests;
- the FLAC decoder (``flac.cc``): ingestion of a FLAC corpus (LibriSpeech's
  format) at thousands of times real time on one host core;
- the zstd decoder and CRC-32C (``zstd.cc``): the Orbax checkpoint reader
  (``io/zstd.py``, ``io/ocdbt.py``, ``io/orbax.py``).

The segmenter's and the FLAC decoder's callers catch
:class:`NativeUnavailable` (no toolchain, a failed build) and fall back; the
zstd decoder has no fallback, so its callers see the error.
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
from typing import List

import numpy as np

SOURCES = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = SOURCES.parent.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeUnavailable(RuntimeError):
    pass


def library_path(name: str) -> Path:
    """Where ``native/<name>.cc`` is built: named by a hash of the source
    and the flags."""
    src = SOURCES / f"{name}.cc"
    if not src.exists():
        raise NativeUnavailable(f"source not found: {src}")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libsylber_{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cc`` if needed; return the library's path."""
    so = library_path(name)
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found: the native libraries are built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCES / f"{name}.cc")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeUnavailable(f"g++ build of {name}.cc failed:\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]


def load_library() -> ctypes.CDLL:
    """The segmenter's library, built and bound on first use."""
    lib = _load("segment")
    if hasattr(lib, "_sylber_bound"):
        return lib
    lib.sylber_segment.restype = ctypes.c_int
    lib.sylber_segment.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
    lib.sylber_segment_batch.restype = None
    lib.sylber_segment_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib._sylber_bound = True
    return lib


def load_flac_library() -> ctypes.CDLL:
    """The FLAC decoder's library, built and bound on first use."""
    lib = _load("flac")
    if hasattr(lib, "_sylber_bound"):
        return lib
    lib.sylber_flac_open.restype = ctypes.c_void_p
    lib.sylber_flac_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.sylber_flac_info.restype = None
    lib.sylber_flac_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.sylber_flac_read.restype = None
    lib.sylber_flac_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.sylber_flac_free.restype = None
    lib.sylber_flac_free.argtypes = [ctypes.c_void_p]
    lib._sylber_bound = True
    return lib


def load_zstd_library() -> ctypes.CDLL:
    """The zstd decoder's library, built and bound on first use."""
    lib = _load("zstd")
    if hasattr(lib, "_sylber_bound"):
        return lib
    lib.sylber_zstd_decompress.restype = ctypes.c_int
    lib.sylber_zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.sylber_zstd_free.restype = None
    lib.sylber_zstd_free.argtypes = [ctypes.c_void_p]
    lib.sylber_crc32c.restype = ctypes.c_uint32
    lib.sylber_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib._sylber_bound = True
    return lib


def decode_flac_native(data: bytes):
    """Decode an in-memory FLAC stream -> ((C, L) int32 PCM, sample_rate,
    bits_per_sample).

    Raises ``NativeUnavailable`` without a toolchain and ``ValueError`` on
    unsupported or corrupt input (the pure-Python decoder then names the
    reason)."""
    lib = load_flac_library()
    h = lib.sylber_flac_open(data, len(data))
    if not h:
        raise ValueError("native FLAC decode failed (unsupported or corrupt)")
    try:
        sr, ch, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        frames = ctypes.c_int64()
        lib.sylber_flac_info(h, ctypes.byref(sr), ctypes.byref(ch),
                             ctypes.byref(bps), ctypes.byref(frames))
        out = np.zeros(frames.value * ch.value, np.int32)
        lib.sylber_flac_read(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out.reshape(-1, ch.value).T, int(sr.value), int(bps.value)
    finally:
        lib.sylber_flac_free(h)


def segment_native(states: np.ndarray, norm_threshold: float,
                   merge_threshold: float) -> np.ndarray:
    """(L, d) float32 -> (n, 2) int64 segments through the C++ segmenter."""
    lib = load_library()
    states = np.ascontiguousarray(states, np.float32)
    L, d = states.shape
    out = np.zeros(((L + 1) * 2,), np.int32)
    n = lib.sylber_segment(
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), L, d,
        norm_threshold, merge_threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[: 2 * n].reshape(n, 2).astype(np.int64)


def segment_native_batch(states: np.ndarray, norm_threshold: float,
                         merge_threshold: float) -> List[np.ndarray]:
    """(B, L, d) float32 -> B arrays of (n_b, 2) int64 segments."""
    lib = load_library()
    states = np.ascontiguousarray(states, np.float32)
    B, L, d = states.shape
    out = np.zeros((B, (L + 1) * 2), np.int32)
    counts = np.zeros((B,), np.int32)
    lib.sylber_segment_batch(
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), B, L, d,
        norm_threshold, merge_threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [out[b, : 2 * counts[b]].reshape(-1, 2).astype(np.int64) for b in range(B)]
