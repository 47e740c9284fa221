"""Zstandard decompression for the Orbax checkpoint reader, with no
``zstandard`` module and no libzstd.

:func:`decompress` decodes every frame of a zstd stream (RFC 8878) through
the port's own C++ decoder, ``native/zstd.cc``, which g++ builds at first use
(``utils/native.py``). There is no fallback: if the build fails, the call
raises. A stream outside what the decoder handles (a dictionary, a reserved
field) or a malformed one (a bad checksum, a truncated frame) raises
``ValueError`` with the decoder's reason. :func:`crc32c` is the checksum of
OCDBT manifests and B-tree nodes (``io/ocdbt.py``).
"""

from __future__ import annotations

import ctypes

from ..utils.native import load_zstd_library


def decompress(data: bytes) -> bytes:
    """Every frame of ``data`` decoded and concatenated (skippable frames
    skipped); ``ValueError`` says what is wrong with a stream it refuses."""
    lib = load_zstd_library()
    data = bytes(data)
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.sylber_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n),
                                  err, len(err)) != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out.value, n.value) if n.value else b""
    finally:
        lib.sylber_zstd_free(out)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    return int(load_zstd_library().sylber_crc32c(bytes(data), len(data)))
