"""Pure-Python FLAC decoder (RFC 9639 subset covering speech corpora).

A copy of ``sylber_tpu/utils/flac.py`` (the port imports nothing of the JAX
package). LibriSpeech ships as FLAC and the port depends on no audio
library, so it carries its own decoder. The faster C++ decoder is the
port's ``native/flac.cc`` (``utils/native.py::decode_flac_native``), which
``utils/audio.py`` tries before this one; this one is the fallback and
names the reason for a stream neither decodes.

Supported (everything libFLAC emits for 8/16/24-bit PCM):
- STREAMINFO + all metadata blocks (skipped), fixed & variable blocksize
  frames, all blocksize/samplerate/bps header codes;
- subframes: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32),
  wasted bits;
- Rice residual methods 0 (4-bit) and 1 (5-bit) incl. escape partitions;
- stereo decorrelation: independent, left/side, right/side, mid/side.

Not supported: bps > 26, >2 channels (never produced for speech corpora;
a clear error is raised). CRCs are parsed but not verified (decode speed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


class FlacError(ValueError):
    pass


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos          # absolute bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            raise FlacError("unexpected end of stream")
        self.pos = p + n
        if n == 0:
            return 0
        first = p >> 3
        last = (p + n - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        shift = 8 * (last + 1 - first) - (p & 7) - n
        return (chunk >> shift) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        """Count 0 bits until the terminating 1 bit."""
        data, p = self.data, self.pos
        count = 0
        # finish the current partial byte
        while True:
            byte_i = p >> 3
            if byte_i >= len(data):
                raise FlacError("unexpected end of stream in unary code")
            b = data[byte_i] & (0xFF >> (p & 7))
            if b:
                # highest set bit position within the byte
                hi = b.bit_length() - 1          # bit index from LSB
                one_pos = (byte_i << 3) + (7 - hi)
                count += one_pos - p
                self.pos = one_pos + 1
                return count
            count += 8 - (p & 7)
            p = (byte_i + 1) << 3

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's extended UTF-8-style coded frame/sample number (1-7 bytes)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n < 1 or n > 6:
        raise FlacError(f"invalid UTF-8 coded number lead byte {b0:#x}")
    val = b0 & (mask - 1)
    for _ in range(n):
        c = br.read(8)
        if c & 0xC0 != 0x80:
            raise FlacError("invalid UTF-8 continuation byte")
        val = (val << 6) | (c & 0x3F)
    return val


_BLOCKSIZE_CODE = {1: 192, **{i: 576 << (i - 2) for i in range(2, 6)},
                   **{i: 256 << (i - 8) for i in range(8, 16)}}
_SAMPLE_SIZE_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SAMPLE_RATE_CODE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                     6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                     11: 96000}


def _decode_residual(br: _BitReader, blocksize: int, order: int
                     ) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual coding method {method}")
    plen = 4 + method
    escape = (1 << plen) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts != 0:
        # spec: blocksize must be evenly divisible by the partition count
        # (the partial-fill would otherwise leave uninitialized residuals)
        raise FlacError(
            f"blocksize {blocksize} not divisible by 2^{porder} partitions")
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for part in range(nparts):
        n = (blocksize >> porder) - (order if part == 0 else 0)
        if n < 0:
            raise FlacError("invalid partition order")
        k = br.read(plen)
        if k == escape:
            raw = br.read(5)
            if raw == 0:
                out[w:w + n] = 0
            else:
                for i in range(n):
                    out[w + i] = br.read_signed(raw)
        else:
            for i in range(n):
                q = br.unary()
                v = (q << k) | br.read(k)
                out[w + i] = (v >> 1) ^ -(v & 1)
        w += n
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FlacError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.unary()
        if wasted >= bps:
            raise FlacError(f"wasted bits {wasted} >= sample size {bps}")
        bps -= wasted

    if stype == 0:  # CONSTANT
        out = np.full(blocksize, br.read_signed(bps), np.int64)
    elif stype == 1:  # VERBATIM
        out = np.empty(blocksize, np.int64)
        for i in range(blocksize):
            out[i] = br.read_signed(bps)
    elif 8 <= stype <= 12:  # FIXED, order stype-8
        order = stype - 8
        out = np.empty(blocksize, np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        res = _decode_residual(br, blocksize, order)
        coefs = _FIXED_COEFS[order]
        o = out.tolist()
        for i in range(order, blocksize):
            p = 0
            for j, c in enumerate(coefs):
                p += c * o[i - 1 - j]
            o[i] = res[i - order] + p
        out = np.asarray(o, np.int64)
    elif stype >= 32:  # LPC, order (stype & 31) + 1
        order = (stype & 31) + 1
        out = np.empty(blocksize, np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        prec = br.read(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision code")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        o = out.tolist()
        rl = res.tolist()
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * o[i - 1 - j]
            o[i] = rl[i - order] + (acc >> shift)
        out = np.asarray(o, np.int64)
    else:
        raise FlacError(f"reserved subframe type {stype:#08b}")

    if wasted:
        out <<= wasted
    return out


def parse_streaminfo(data: bytes) -> dict:
    """Parse the fLaC marker + STREAMINFO; returns header info and the bit
    offset of the first audio frame."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    br = _BitReader(data, 32)
    info = None
    while True:
        last = br.read(1)
        btype = br.read(7)
        length = br.read(24)
        if btype == 0:
            if length < 34:
                raise FlacError("short STREAMINFO")
            sub = _BitReader(data, br.pos)
            info = {
                "min_blocksize": sub.read(16),
                "max_blocksize": sub.read(16),
                "min_framesize": sub.read(24),
                "max_framesize": sub.read(24),
                "sample_rate": sub.read(20),
                "channels": sub.read(3) + 1,
                "bits_per_sample": sub.read(5) + 1,
                "total_samples": sub.read(36),
            }
        br.pos += 8 * length
        if last:
            break
    if info is None:
        raise FlacError("missing STREAMINFO block")
    info["frame_start_bit"] = br.pos
    return info


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream -> ((C, L) int32 PCM, sample_rate, bits_per_sample)."""
    info = parse_streaminfo(data)
    channels = info["channels"]
    if channels > 2:
        raise FlacError(f"{channels}-channel FLAC not supported")
    if info["bits_per_sample"] > 26:
        raise FlacError("bps > 26 not supported")
    br = _BitReader(data, info["frame_start_bit"])
    chunks = []
    total = info["total_samples"]
    decoded = 0
    while br.pos + 32 <= br.nbits and (not total or decoded < total):
        sync = br.read(14)
        if sync != 0x3FFE:
            raise FlacError(f"bad frame sync {sync:#x} at bit {br.pos - 14}")
        if br.read(1):
            raise FlacError("reserved frame header bit set")
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        if br.read(1):
            raise FlacError("reserved frame header bit set")
        _read_utf8_number(br)
        if bs_code == 0:
            raise FlacError("reserved blocksize code 0")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise FlacError("invalid sample rate code")
        br.read(8)  # header CRC-8 (not verified)

        if ss_code != 0 and ss_code not in _SAMPLE_SIZE_CODE:
            raise FlacError(f"reserved sample size code {ss_code}")
        bps = (info["bits_per_sample"] if ss_code == 0
               else _SAMPLE_SIZE_CODE[ss_code])
        if ch_code < 8:
            nch = ch_code + 1
            if nch != channels:
                raise FlacError("frame/STREAMINFO channel mismatch")
            subs = [_decode_subframe(br, blocksize, bps)
                    for _ in range(nch)]
        elif ch_code in (8, 9, 10):
            if channels != 2:
                raise FlacError("stereo decorrelation in non-stereo stream")
            extra0 = 1 if ch_code == 9 else 0
            extra1 = 1 if ch_code in (8, 10) else 0
            c0 = _decode_subframe(br, blocksize, bps + extra0)
            c1 = _decode_subframe(br, blocksize, bps + extra1)
            if ch_code == 8:      # left/side
                subs = [c0, c0 - c1]
            elif ch_code == 9:    # right/side (side, right)
                subs = [c1 + c0, c1]
            else:                 # mid/side
                mid = (c0 << 1) | (c1 & 1)
                subs = [(mid + c1) >> 1, (mid - c1) >> 1]
        else:
            raise FlacError(f"reserved channel assignment {ch_code}")

        br.align()
        br.read(16)  # frame CRC-16 (not verified)
        chunks.append(np.stack(subs))
        decoded += blocksize

    if not chunks:
        raise FlacError("no audio frames decoded")
    pcm = np.concatenate(chunks, axis=1)
    if total:
        pcm = pcm[:, :total]
    return pcm.astype(np.int32), info["sample_rate"], info["bits_per_sample"]


def decode_flac_file(path) -> Tuple[np.ndarray, int, int]:
    with open(path, "rb") as f:
        return decode_flac(f.read())
