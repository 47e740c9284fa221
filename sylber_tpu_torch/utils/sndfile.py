"""Optional ctypes binding to a system or bundled libsndfile.

Port of ``sylber_tpu/utils/sndfile.py``. Used (a) as the first FLAC decoder
and the only OGG/Vorbis decoder of ``utils/audio.py`` (the reference reads
any format torchaudio reads), and (b) as an independent third-party oracle
and the fixture encoder of the FLAC tests (:func:`write`).

No pip package is needed: the loader probes the usual soname, then shared
libraries bundled inside installed wheels (pygame vendors libsndfile and
its codecs). The probe runs on first use, once a process, and failure is
not fatal: callers catch :class:`SndfileUnavailable`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_SEARCHED = False


class SndfileUnavailable(RuntimeError):
    pass


class _SF_INFO(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.c_int64),
        ("samplerate", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("format", ctypes.c_int),
        ("sections", ctypes.c_int),
        ("seekable", ctypes.c_int),
    ]


SFM_READ, SFM_WRITE = 0x10, 0x20
SF_FORMAT_WAV = 0x010000
SF_FORMAT_FLAC = 0x170000
SF_FORMAT_OGG = 0x200000
SF_FORMAT_PCM_16 = 0x0002
SF_FORMAT_VORBIS = 0x0060


def _candidate_paths():
    yield "libsndfile.so.1"
    yield "libsndfile.so"
    for sp in sys.path:
        libs = os.path.join(sp, "pygame.libs")
        if os.path.isdir(libs):
            for p in sorted(glob.glob(os.path.join(libs, "libsndfile*.so*"))):
                yield p


def _preload_codecs(libdir: str) -> None:
    """Vendored libsndfile builds reference vendored codec sonames; preload
    whatever codec libraries sit next to it with RTLD_GLOBAL."""
    pats = ("libFLAC", "libogg", "libvorbis", "libopus", "libmpg123")
    for p in sorted(os.listdir(libdir)):
        if p.startswith(pats):
            try:
                ctypes.CDLL(os.path.join(libdir, p), mode=ctypes.RTLD_GLOBAL)
            except OSError:
                pass


def load_library() -> ctypes.CDLL:
    global _LIB, _SEARCHED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _SEARCHED:
            raise SndfileUnavailable("libsndfile not found (cached)")
        _SEARCHED = True
        last_err: Optional[Exception] = None
        for cand in _candidate_paths():
            try:
                lib = ctypes.CDLL(cand)
            except OSError as e:
                if os.path.isabs(cand):
                    _preload_codecs(os.path.dirname(cand))
                    try:
                        lib = ctypes.CDLL(cand)
                    except OSError as e2:
                        last_err = e2
                        continue
                else:
                    last_err = e
                    continue
            lib.sf_open.restype = ctypes.c_void_p
            lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(_SF_INFO)]
            lib.sf_close.argtypes = [ctypes.c_void_p]
            lib.sf_readf_short.restype = ctypes.c_int64
            lib.sf_readf_short.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64]
            lib.sf_readf_float.restype = ctypes.c_int64
            lib.sf_readf_float.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64]
            lib.sf_writef_short.restype = ctypes.c_int64
            lib.sf_writef_short.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64]
            lib.sf_strerror.restype = ctypes.c_char_p
            lib.sf_strerror.argtypes = [ctypes.c_void_p]
            _LIB = lib
            return lib
        raise SndfileUnavailable(f"libsndfile not found ({last_err})")


def available() -> bool:
    try:
        load_library()
        return True
    except SndfileUnavailable:
        return False


def read(path: str | Path, dtype: str = "float32"
         ) -> Tuple[np.ndarray, int]:
    """Decode any libsndfile-supported file -> ((C, L) array, sample_rate).

    ``dtype='float32'`` returns [-1, 1] floats; ``'int16'`` raw PCM.
    """
    lib = load_library()
    info = _SF_INFO()
    h = lib.sf_open(str(path).encode(), SFM_READ, ctypes.byref(info))
    if not h:
        raise SndfileUnavailable(
            f"sf_open failed for {path}: {lib.sf_strerror(None).decode()}")
    try:
        n, c = int(info.frames), int(info.channels)
        if dtype == "int16":
            buf = np.zeros(n * c, np.int16)
            got = lib.sf_readf_short(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
        else:
            buf = np.zeros(n * c, np.float32)
            got = lib.sf_readf_float(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        buf = buf[: got * c].reshape(-1, c).T  # (C, L)
        return buf, int(info.samplerate)
    finally:
        lib.sf_close(h)


def write(path: str | Path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write int16 PCM ((L,) or (C, L)) as WAV/FLAC/OGG by extension."""
    lib = load_library()
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise ValueError("write expects int16 PCM")
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    C, L = pcm.shape
    ext = str(path).rsplit(".", 1)[-1].lower()
    fmt = {"wav": SF_FORMAT_WAV | SF_FORMAT_PCM_16,
           "flac": SF_FORMAT_FLAC | SF_FORMAT_PCM_16,
           "ogg": SF_FORMAT_OGG | SF_FORMAT_VORBIS}[ext]
    info = _SF_INFO(0, sample_rate, C, fmt, 0, 0)
    h = lib.sf_open(str(path).encode(), SFM_WRITE, ctypes.byref(info))
    if not h:
        raise SndfileUnavailable(
            f"sf_open(write) failed for {path}: "
            f"{lib.sf_strerror(None).decode()}")
    try:
        inter = np.ascontiguousarray(pcm.T.reshape(-1))
        lib.sf_writef_short(
            h, inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), L)
    finally:
        lib.sf_close(h)
