# -*- coding: utf-8 -*-
"""FLAC encode/decode for the serving surfaces (mono, 16-bit).

The reference returns WAV/base64 only (api/endpoints.py writes .wav
files); OpenAI's ``/v1/audio/speech`` contract also offers ``flac``, and
this module backs that format here without external codec dependencies:

- ``encode_flac``: PCM16 -> FLAC stream. Hot path is the native encoder
  (csrc/flacenc.cpp, built with g++ at first use or at ``prewarm()`` into
  ``build/native/flacenc-<source hash>/`` at the root of the checkout,
  never at import); the pure numpy/Python fallback produces
  byte-identical output (asserted in tests/test_flac.py).
- ``decode_flac``: pure-Python decoder with CRC-8/CRC-16/MD5
  verification — used by the tests to prove lossless round-trips, and
  by clients that want to read the files back.

Format per RFC 9639: fixed-blocksize stream, one CONSTANT / VERBATIM /
FIXED(0-4) subframe per frame, Rice method 0, partition order 0. The
decoder additionally understands escaped partitions and higher
partition orders for robustness against other encoders' output.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "flacenc.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_tried = False

_BLOCKSIZE_CODES = {
    192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
    8192: 13, 16384: 14, 32768: 15,
}
_SAMPLERATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}


def prewarm(background: bool = True) -> None:
    """Build/load the native encoder ahead of traffic (ADVICE r3: the
    lazy g++ build cost up to 120 s inside the first FLAC request).
    Called at server startup; idempotent and cheap once built."""
    if background:
        threading.Thread(target=_get_lib, daemon=True,
                         name="flac-prewarm").start()
    else:
        _get_lib()


def library_path() -> str:
    """Where the native encoder's library lives: a directory keyed by a
    hash of the source and the flags, as ``ops/cuda_build.py`` keys the
    kernels, so an edited source builds anew."""
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_GXX_FLAGS).encode())
    return os.path.join(_BUILD_ROOT, f"flacenc-{key.hexdigest()[:16]}",
                        "libttsflac.so")


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = library_path()
        if not os.path.exists(so):
            # built under a per-process name, then renamed: a concurrent
            # loader never sees half a library
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                os.makedirs(os.path.dirname(so), exist_ok=True)
                subprocess.run(
                    ["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)
            except Exception as exc:
                logger.warning(
                    "native flac build unavailable (%s); falling back to"
                    " the SLOW pure-Python encoder", exc)
                return None
        try:
            lib = ctypes.CDLL(so)
            lib.flac_encode_frames.restype = ctypes.c_size_t
            lib.flac_encode_frames.argtypes = [
                ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
                ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
            logger.info("native flac encoder loaded: %s", so)
        except OSError as exc:
            logger.warning(
                "native flac load failed (%s); falling back to the SLOW"
                " pure-Python encoder", exc)
    return _lib


# ---------------------------------------------------------------------------
# bit I/O (fallback encoder + decoder)
# ---------------------------------------------------------------------------

class _BitWriter:
    __slots__ = ("buf", "acc", "fill")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.fill = 0

    def put(self, val: int, n: int) -> None:
        self.acc = (self.acc << n) | (val & ((1 << n) - 1))
        self.fill += n
        while self.fill >= 8:
            self.buf.append((self.acc >> (self.fill - 8)) & 0xFF)
            self.fill -= 8
        self.acc &= (1 << self.fill) - 1

    def put_unary(self, q: int) -> None:
        self.put(1, q + 1)

    def align(self) -> None:
        if self.fill:
            self.put(0, 8 - self.fill)


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0) -> None:
        self.data = data
        self.pos = pos_bits

    def get(self, n: int) -> int:
        v = 0
        p = self.pos
        for _ in range(n):
            v = (v << 1) | ((self.data[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def get_signed(self, n: int) -> int:
        v = self.get(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def get_unary(self) -> int:
        q = 0
        p = self.pos
        d = self.data
        while not (d[p >> 3] >> (7 - (p & 7))) & 1:
            q += 1
            p += 1
        self.pos = p + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _crc8(data: bytes) -> int:
    c = 0
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for byte in data:
        c ^= byte << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


def _utf8_code(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for extra, lead, limit in (
        (1, 0xC0, 0x800), (2, 0xE0, 0x10000), (3, 0xF0, 0x200000),
        (4, 0xF8, 0x4000000), (5, 0xFC, 1 << 31),
    ):
        if v < limit:
            out = [lead | (v >> (6 * extra))]
            out += [0x80 | ((v >> (6 * (extra - i))) & 0x3F)
                    for i in range(1, extra + 1)]
            return bytes(out)
    raise ValueError("frame number too large")


def _utf8_decode(br: _BitReader) -> int:
    b0 = br.get(8)
    if b0 < 0x80:
        return b0
    extra = 0
    mask = 0x40
    while b0 & mask:
        extra += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(extra):
        v = (v << 6) | (br.get(8) & 0x3F)
    return v


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _samplerate_fields(sr: int) -> Tuple[int, int, int]:
    """(code, tail_bits, tail_val) for the frame-header sample-rate field."""
    code = _SAMPLERATE_CODES.get(sr)
    if code is not None:
        return code, 0, 0
    if sr % 1000 == 0 and sr // 1000 < 256:
        return 12, 8, sr // 1000
    if sr < 65536:
        return 13, 16, sr
    if sr % 10 == 0 and sr // 10 < 65536:
        return 14, 16, sr // 10
    return 0, 0, 0  # decoder falls back to STREAMINFO


def _encode_frames_py(pcm: np.ndarray, sample_rate: int,
                      block_size: int) -> bytes:
    """numpy/Python frame encoder — byte-identical to csrc/flacenc.cpp."""
    out = bytearray()
    src, sr_bits, sr_val = _samplerate_fields(sample_rate)
    n = pcm.size
    for frame_idx, start in enumerate(range(0, n, block_size)):
        x = pcm[start:start + block_size].astype(np.int32)
        bs = x.size
        bsc = _BLOCKSIZE_CODES.get(bs)
        need8 = need16 = False
        if bsc is None:
            if bs <= 256:
                bsc, need8 = 6, True
            else:
                bsc, need16 = 7, True

        header = bytearray([0xFF, 0xF8, (bsc << 4) | src, 0x08])
        header += _utf8_code(frame_idx)
        if need8:
            header.append(bs - 1)
        if need16:
            header += struct.pack(">H", bs - 1)
        if sr_bits == 8:
            header.append(sr_val)
        elif sr_bits == 16:
            header += struct.pack(">H", sr_val)
        header.append(_crc8(bytes(header)))

        bw = _BitWriter()
        if bs and bool(np.all(x == x[0])):
            bw.put(0x00, 8)  # CONSTANT
            bw.put(int(x[0]), 16)
        else:
            max_order = 4 if bs > 4 else bs - 1
            res = [x]
            for _ in range(max_order):
                res.append(np.diff(res[-1]))
            abs_sums = [int(np.abs(r).sum()) for r in res]
            best_o = int(np.argmin(abs_sums))
            e = res[best_o]
            u = ((e << 1) ^ (e >> 31)).astype(np.uint32)
            shifted = u[None, :].astype(np.uint64) >> np.arange(15, dtype=np.uint64)[:, None]
            costs = shifted.sum(axis=1) + (np.arange(15, dtype=np.uint64) + 1) * u.size
            best_k = int(np.argmin(costs))
            best_bits = int(costs[best_k])
            fixed_bits = 8 + 16 * best_o + 10 + best_bits
            if fixed_bits >= 8 + 16 * bs:
                bw.put(0x02, 8)  # VERBATIM
                for v in x:
                    bw.put(int(v), 16)
            else:
                bw.put((8 + best_o) << 1, 8)  # FIXED
                for v in x[:best_o]:
                    bw.put(int(v), 16)
                bw.put(0, 2)
                bw.put(0, 4)
                bw.put(best_k, 4)
                qs = (u >> best_k).tolist()
                rs = (u & ((1 << best_k) - 1)).tolist() if best_k else None
                for i, q in enumerate(qs):
                    bw.put_unary(q)
                    if best_k:
                        bw.put(rs[i], best_k)
        bw.align()
        frame = bytes(header) + bytes(bw.buf)
        out += frame
        out += struct.pack(">H", _crc16(frame))
    return bytes(out)


def _encode_frames_native(pcm: np.ndarray, sample_rate: int,
                          block_size: int) -> Optional[bytes]:
    lib = _get_lib()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(pcm, np.int16)
    cap = pcm.size * 2 + (pcm.size // block_size + 2) * 64 + 128
    out = np.empty(cap, np.uint8)
    scratch = np.empty(6 * block_size, np.int32)
    written = lib.flac_encode_frames(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), pcm.size,
        sample_rate, block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if not written:
        return None
    return out[:written].tobytes()


def encode_flac(pcm: np.ndarray, sample_rate: int = 24000,
                block_size: int = 4096) -> bytes:
    """Mono int16 PCM -> complete FLAC stream bytes (lossless)."""
    pcm = np.ascontiguousarray(np.asarray(pcm).reshape(-1), np.int16)
    if not 16 <= block_size <= 32768:
        raise ValueError(f"block_size out of range: {block_size}")
    frames = _encode_frames_native(pcm, sample_rate, block_size)
    if frames is None:
        frames = _encode_frames_py(pcm, sample_rate, block_size)

    md5 = hashlib.md5(pcm.astype("<i2").tobytes()).digest()
    info = _BitWriter()
    info.put(block_size, 16)   # min blocksize (fixed-blocksize stream)
    info.put(block_size, 16)   # max blocksize
    info.put(0, 24)            # min framesize: unknown
    info.put(0, 24)            # max framesize: unknown
    info.put(sample_rate, 20)
    info.put(0, 3)             # channels - 1
    info.put(15, 5)            # bits per sample - 1
    info.put(pcm.size, 36)
    header = (
        b"fLaC"
        + bytes([0x80, 0, 0, 34])  # last-metadata, STREAMINFO, length 34
        + bytes(info.buf) + md5
    )
    return header + frames


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

_FIXED_COEFFS = {
    0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1],
}


def decode_flac(data: bytes, verify: bool = True) -> Tuple[np.ndarray, int]:
    """FLAC stream -> (mono int16 samples, sample_rate).

    Decodes the subset this framework emits (mono, 16-bit, constant /
    verbatim / fixed subframes) plus escaped Rice partitions and
    arbitrary partition orders. CRC-8/CRC-16/MD5 checked when
    ``verify``."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = bits = channels = total = None
    md5_expect = b"\x00" * 16
    while True:
        head = data[pos:pos + 4]
        if len(head) < 4:  # truncated inside a metadata header: same
            # ValueError contract as frame-level truncation (ADVICE r3)
            raise ValueError("truncated or corrupt FLAC metadata")
        last = head[0] & 0x80
        btype = head[0] & 0x7F
        blen = int.from_bytes(head[1:4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if len(body) < blen:
            raise ValueError("truncated or corrupt FLAC metadata")
        if btype == 0:
            br = _BitReader(body)
            br.get(16), br.get(16), br.get(24), br.get(24)
            sample_rate = br.get(20)
            channels = br.get(3) + 1
            bits = br.get(5) + 1
            total = br.get(36)
            md5_expect = body[18:34]
        pos += 4 + blen
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")
    if channels != 1:
        raise ValueError(f"only mono supported (stream has {channels})")

    out = []
    while pos < len(data):
        try:
            pos = _decode_frame(data, pos, bits, out, verify)
        except IndexError:
            raise ValueError("truncated or corrupt FLAC frame")

    pcm = (np.concatenate(out) if out else np.empty(0, np.int64))
    if total:
        pcm = pcm[:total]
    pcm = pcm.astype(np.int16)
    if verify and md5_expect != b"\x00" * 16:
        got = hashlib.md5(pcm.astype("<i2").tobytes()).digest()
        if got != md5_expect:
            raise ValueError("decoded audio MD5 mismatch")
    return pcm, sample_rate


def _decode_frame(data: bytes, pos: int, bits: int, out: list,
                  verify: bool) -> int:
    """Decode one frame starting at byte ``pos``; append samples to
    ``out`` and return the byte position after the frame."""
    frame_start = pos
    br = _BitReader(data, pos * 8)
    sync = br.get(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync at byte {pos}")
    br.get(1)  # reserved
    br.get(1)  # blocking strategy
    bsc = br.get(4)
    src = br.get(4)
    chan = br.get(4)
    bps_code = br.get(3)
    br.get(1)
    _utf8_decode(br)
    if bsc == 1:
        bs = 192
    elif 2 <= bsc <= 5:
        bs = 576 << (bsc - 2)
    elif bsc == 6:
        bs = br.get(8) + 1
    elif bsc == 7:
        bs = br.get(16) + 1
    elif bsc >= 8:
        bs = 256 << (bsc - 8)
    else:
        raise ValueError("reserved blocksize code")
    if src == 12:
        br.get(8)
    elif src in (13, 14):
        br.get(16)
    bps = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(bps_code, bits)
    if chan != 0:
        raise ValueError("only mono frames supported")
    header_end = br.pos // 8
    crc8_read = br.get(8)
    if verify and _crc8(data[frame_start:header_end]) != crc8_read:
        raise ValueError(f"frame header CRC mismatch at byte {frame_start}")

    # one subframe (mono)
    if br.get(1):
        raise ValueError("bad subframe padding bit")
    stype = br.get(6)
    wasted = 0
    if br.get(1):
        wasted = 1 + br.get_unary()
    eff_bps = bps - wasted
    if stype == 0:
        samples = np.full(bs, br.get_signed(eff_bps), np.int64)
    elif stype == 1:
        samples = np.array([br.get_signed(eff_bps) for _ in range(bs)],
                           np.int64)
    elif 8 <= stype <= 12:
        order = stype - 8
        warm = [br.get_signed(eff_bps) for _ in range(order)]
        method = br.get(2)
        if method > 1:
            raise ValueError("reserved residual method")
        pbits = 4 + method
        escape = (1 << pbits) - 1
        porder = br.get(4)
        nparts = 1 << porder
        res = []
        for p in range(nparts):
            cnt = (bs >> porder) - (order if p == 0 else 0)
            k = br.get(pbits)
            if k == escape:
                raw = br.get(5)
                res += [br.get_signed(raw) if raw else 0
                        for _ in range(cnt)]
            else:
                for _ in range(cnt):
                    q = br.get_unary()
                    u = (q << k) | (br.get(k) if k else 0)
                    res.append((u >> 1) ^ -(u & 1))
        samples = np.empty(bs, np.int64)
        samples[:order] = warm
        coeffs = _FIXED_COEFFS[order]
        hist = list(warm)
        for i, e in enumerate(res):
            v = e + sum(c * hist[-1 - j] for j, c in enumerate(coeffs))
            samples[order + i] = v
            if order:
                hist.append(v)
                hist = hist[-order:]
    else:
        raise ValueError(f"unsupported subframe type {stype} (LPC?)")
    if wasted:
        samples = samples << wasted
    br.align()
    body_end = br.pos // 8
    crc16_read = br.get(16)
    if verify and _crc16(data[frame_start:body_end]) != crc16_read:
        raise ValueError(f"frame CRC-16 mismatch at byte {frame_start}")
    out.append(samples)
    return br.pos // 8
