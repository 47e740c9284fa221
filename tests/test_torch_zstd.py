"""The port's zstd decoder (``native/zstd.cc`` through ``io/zstd.py``) against
libzstd.

libzstd (``libzstd.so.1``, reached through ctypes in a subprocess; the
test skips without it) compresses random, text-like and all-equal buffers
of 0 B, 1 B, 128 KiB and 3 MiB at levels -5, 1, 3 and 19, with and without
the content checksum and the frame content size (each case takes one of
the four, in turn, and one size and level takes all four); the decoder must
give the input back byte for byte. Two concatenated frames, with a skippable frame between,
decode to the two inputs joined. A corrupted checksum, a truncated frame, a
dictionary ID and a reserved block type each raise ``ValueError`` naming the
fault. CRC-32C is held to its published check value.
"""

import ctypes.util
import itertools
import subprocess
import sys

import numpy as np
import pytest

from sylber_tpu_torch.io.zstd import crc32c, decompress

LIBZSTD = ctypes.util.find_library("zstd")  # the name only: libzstd is loaded in a subprocess
pytestmark = pytest.mark.skipif(LIBZSTD is None, reason="libzstd.so.1 is not installed")

# libzstd runs in a fresh interpreter: a test process that has imported
# TensorFlow (transformers does) holds TensorFlow's own zstd symbols in its
# global scope, and libzstd's calls into its own exported functions then bind
# to those and crash.
COMPRESS = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
level, checksum, content_size = map(int, sys.argv[2:5])
data = sys.stdin.buffer.read()
lib.ZSTD_createCCtx.restype = ctypes.c_void_p
lib.ZSTD_compressBound.restype = ctypes.c_size_t
lib.ZSTD_compress2.restype = ctypes.c_size_t
lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_char_p, ctypes.c_size_t]
lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
cctx = lib.ZSTD_createCCtx()
# ZSTD_c_compressionLevel, ZSTD_c_checksumFlag, ZSTD_c_contentSizeFlag
for param, value in ((100, level), (201, checksum), (200, content_size)):
    assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param, value))
cap = lib.ZSTD_compressBound(ctypes.c_size_t(len(data)))
dst = ctypes.create_string_buffer(cap)
n = lib.ZSTD_compress2(cctx, dst, cap, data, len(data))
assert not lib.ZSTD_isError(n)
lib.ZSTD_freeCCtx(cctx)
sys.stdout.buffer.write(dst.raw[:n])
"""


def compress(data: bytes, level: int, checksum: bool, content_size: bool) -> bytes:
    """One zstd frame of ``data`` from libzstd."""
    run = subprocess.run([sys.executable, "-I", "-c", COMPRESS, LIBZSTD, str(level),
                          str(int(checksum)), str(int(content_size))],
                         input=data, capture_output=True, timeout=120)
    assert run.returncode == 0, run.stderr.decode()[-2000:]
    return run.stdout


def buffer(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size + len(kind))
    if kind == "random":
        return rng.bytes(size)
    if kind == "equal":
        return b"\x5a" * size
    words = [b"syllable", b"segment", b"hubert", b"the", b"of", b"boundary", b"\n", b"0.25,"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), size // 3 + 8))
    return text[:size]


KINDS, SIZES, LEVELS = ("random", "text", "equal"), (0, 1, 128 << 10, 3 << 20), (-5, 1, 3, 19)
FLAGS = list(itertools.product((False, True), (False, True)))  # (checksum, content size)
CASES = [(k, s, lv, FLAGS[i % 4])
         for i, (k, s, lv) in enumerate(itertools.product(KINDS, SIZES, LEVELS))]


@pytest.mark.parametrize("kind,size,level,flags", CASES,
                         ids=[f"{k}-{s}-{lv}-ck{int(f[0])}cs{int(f[1])}" for k, s, lv, f in CASES])
def test_decoder_equals_libzstd(kind, size, level, flags):
    data = buffer(kind, size)
    assert decompress(compress(data, level, *flags)) == data


@pytest.mark.parametrize("checksum,content_size", FLAGS)
def test_checksum_and_content_size_flags(checksum, content_size):
    data = buffer("text", 300_000)  # three blocks, repeat offsets across them
    frame = compress(data, 3, checksum, content_size)
    assert bool(frame[4] & 4) == checksum and bool(frame[4] >> 6 or frame[4] & 32) == content_size
    assert decompress(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = buffer("text", 70_000), buffer("random", 5000)
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"xyz"
    assert decompress(compress(a, 19, True, True) + skip + compress(b, -5, False, False)) == a + b


def _raw_frame(header: bytes, payload: bytes, block_type: int = 0) -> bytes:
    """A frame of one last block of ``payload`` after ``header`` (descriptor
    and the fields it announces)."""
    bh = (len(payload) << 3) | (block_type << 1) | 1
    return (0xFD2FB528).to_bytes(4, "little") + header + bh.to_bytes(3, "little") + payload


def test_corrupt_and_unsupported_frames_raise():
    data = buffer("text", 100_000)
    frame = bytearray(compress(data, 3, True, True))
    frame[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        decompress(bytes(frame))
    with pytest.raises(ValueError, match="truncated"):
        decompress(compress(data, 3, False, True)[:-7])
    # descriptor 0x01: a 1-byte dictionary ID (7), then the window descriptor
    with pytest.raises(ValueError, match="dictionar"):
        decompress(_raw_frame(bytes([0x01, 0x00, 7]), b"abc"))
    with pytest.raises(ValueError, match="reserved block type"):
        decompress(_raw_frame(bytes([0x00, 0x00]), b"abc", block_type=3))
    with pytest.raises(ValueError, match="not a zstd frame"):
        decompress(b"\x00" * 16)
    assert decompress(_raw_frame(bytes([0x00, 0x00]), b"abc")) == b"abc"


def test_crc32c_check_values():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
