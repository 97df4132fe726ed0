# -*- coding: utf-8 -*-
"""WAV encode/decode with the stdlib (no torchaudio/soundfile dependency).

Replaces the reference's torchaudio.save/read round-trip
(reference: src/illufly_tts/core/service.py:373-404, api/endpoints.py:148).
Audio also stays in memory as bytes for the API path (SURVEY §7 step 5)."""
from __future__ import annotations

import io
import struct
import wave

import numpy as np


def encode_wav(audio: np.ndarray, sample_rate: int = 24000) -> bytes:
    """Waveform (float32 [-1,1]-ish, or already-int16 PCM) -> WAV bytes."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        pcm = audio.astype("<i2")
    else:
        audio = audio.astype(np.float32)
        peak = np.max(np.abs(audio)) if audio.size else 0.0
        if peak > 1.0:
            audio = audio / peak
        pcm = np.round(
            np.clip(audio, -1.0, 1.0) * 32767.0
        ).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def save_wav(path: str, audio: np.ndarray, sample_rate: int = 24000) -> None:
    with open(path, "wb") as f:
        f.write(encode_wav(audio, sample_rate))


def save_audio(path: str, audio: np.ndarray, sample_rate: int = 24000) -> None:
    """Write audio by output extension: ``.flac`` -> lossless FLAC
    (audio/flac.py), anything else -> 16-bit PCM WAV. Float input is
    peak-normalized/quantized identically on both paths (the FLAC file
    holds exactly the samples the WAV would)."""
    if path.lower().endswith(".flac"):
        from .flac import encode_flac

        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32)
            peak = np.max(np.abs(audio)) if audio.size else 0.0
            if peak > 1.0:
                audio = audio / peak
            audio = np.round(
                np.clip(audio, -1.0, 1.0) * 32767.0
            ).astype(np.int16)
        with open(path, "wb") as f:
            f.write(encode_flac(audio, sample_rate))
        return
    save_wav(path, audio, sample_rate)


def encode_wav_mulaw(mulaw: np.ndarray, sample_rate: int = 8000) -> bytes:
    """uint8 G.711 mu-law bytes -> WAV (format 7). The stdlib ``wave``
    module only writes format 1 (PCM), so the RIFF header is hand-rolled;
    format 7 requires the fact chunk and cbSize=0 extension field."""
    data = np.ascontiguousarray(mulaw, dtype=np.uint8).tobytes()
    n = len(data)
    fmt = struct.pack(
        "<HHIIHHH", 7, 1, sample_rate, sample_rate, 1, 8, 0
    )  # wFormatTag=7 (mu-law), mono, 1 byte/sample, cbSize=0
    fact = struct.pack("<I", n)
    pad = b"\x00" if n % 2 else b""
    body = (
        b"WAVE"
        + b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"fact" + struct.pack("<I", len(fact)) + fact
        + b"data" + struct.pack("<I", n) + data + pad
    )
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _decode_wav_mulaw(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a format-7 (mu-law) RIFF by chunk walk; stdlib wave
    rejects non-PCM formats."""
    from .telephony import mulaw_decode_np

    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    pos, rate, payload = 12, 8000, b""
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            rate = struct.unpack("<I", body[4:8])[0]
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size % 2)
    return mulaw_decode_np(np.frombuffer(payload, np.uint8)), rate


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    # format tag lives at offset 20 in the canonical layout; 7 = mu-law
    if len(data) > 22 and data[12:16] == b"fmt " and data[20:22] == b"\x07\x00":
        return _decode_wav_mulaw(data)
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
    if width == 2:
        pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    elif width == 4:
        pcm = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483647.0
    elif width == 3:
        # 24-bit little-endian: widen to int32 with sign extension (the
        # old uint8 fallback reinterpreted each sample as three bytes of
        # full-scale noise)
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val -= (val & 0x800000) << 1  # sign-extend bit 23
        pcm = val.astype(np.float32) / 8388607.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 127.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    return pcm, rate


def load_wav(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_wav(f.read())
