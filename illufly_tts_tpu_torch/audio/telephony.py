# -*- coding: utf-8 -*-
"""Telephony output: 24 kHz -> 8 kHz resample + G.711 mu-law on the device
(PyTorch port of ``illufly_tts_tpu/audio/telephony.py``).

``mulaw8k`` ships uint8 G.711 mu-law at 8 kHz, 1 byte per telephony
sample; ``mulaw24k`` ships uint8 mu-law at the full 24 kHz as a wire codec
(half the bytes of pcm16) that the host expands back to PCM. The encoder
reproduces the 14-bit ITU algorithm bit for bit: 16-bit PCM is
arithmetic-shifted to 14 bits, biased by 33, clipped to 8159,
segment-coded and complemented. The numpy half (``mulaw_encode_np``,
``mulaw_decode_np``, ``mulaw_lut``) is the host reference and the host's
expansion table.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

RATIO = 3                   # 24 kHz -> 8 kHz
TELEPHONY_RATE = 8000
_SEG_ENDS = (63, 127, 255, 511, 1023, 2047, 4095, 8191)


def design_decimation_fir(
    num_taps: int = 73,
    cutoff_hz: float = 3600.0,
    sample_rate: int = 24000,
    beta: float = 8.6,
) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for decimate-by-3 (odd taps, linear
    phase, DC gain exactly 1). beta=8.6 gives ~90 dB sidelobes; the 3.6 kHz
    cutoff leaves the 300-3400 Hz telephony band flat and puts the 4 kHz
    Nyquist edge deep in the transition."""
    if num_taps % 2 != 1:
        raise ValueError("linear phase needs an odd number of taps")
    n = np.arange(num_taps) - (num_taps - 1) / 2
    fc = cutoff_hz / sample_rate
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def resample_to_8k(audio: torch.Tensor, taps) -> torch.Tensor:
    """[B, S] float32 at 24 kHz -> [B, S // 3] float32 at 8 kHz.

    Output sample i is the FIR centered on input sample 3 i, so one
    600-sample model frame maps to 200 output samples. S must be divisible
    by 3 (it is: samples_per_frame = 600)."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=audio.device)
    k = taps.shape[0]
    pad_l = (k - 1) // 2
    pad_r = (k - 3) - pad_l  # out_len == S // 3 exactly
    x = F.pad(audio.float()[:, None, :], (pad_l, pad_r))
    # a correlation, as lax.conv_general_dilated (the taps are symmetric)
    return F.conv1d(x, taps[None, None, :], stride=RATIO)[:, 0, :]


def mulaw_encode(audio: torch.Tensor) -> torch.Tensor:
    """float32 [-1, 1] -> uint8 G.711 mu-law bytes (on the tensor's
    device). ``torch.round`` rounds half to even, as ``jnp.round``; ``>>``
    on int32 is arithmetic."""
    x16 = torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(
        torch.int32)
    x14 = x16 >> 2
    neg = x14 < 0
    mag = torch.where(neg, -x14, x14)
    mag = torch.clamp(mag, max=8159) + 33
    seg = torch.zeros_like(mag)
    for t in _SEG_ENDS:
        seg = seg + (mag > t).to(torch.int32)
    # mag > 0, so the arithmetic shift is the logical one
    body = (seg << 4) | ((mag >> (seg + 1)) & 0xF)
    body = torch.where(seg >= 8, torch.full_like(body, 0x7F), body)
    mask = torch.where(neg, torch.full_like(body, 0x7F),
                       torch.full_like(body, 0xFF))
    return (body ^ mask).to(torch.uint8)


def mulaw_encode_np(x16: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law (host reference, the same bit-exact
    algorithm)."""
    x14 = (x16.astype(np.int32)) >> 2
    neg = x14 < 0
    mag = np.where(neg, -x14, x14)
    mag = np.minimum(mag, 8159) + 33
    seg = np.zeros_like(mag)
    for t in _SEG_ENDS:
        seg += (mag > t).astype(np.int32)
    body = (seg << 4) | ((mag >> (seg + 1)) & 0xF)
    body = np.where(seg >= 8, 0x7F, body)
    mask = np.where(neg, 0x7F, 0xFF)
    return (body ^ mask).astype(np.uint8)


def mulaw_decode_np(u8: np.ndarray) -> np.ndarray:
    """uint8 mu-law -> float32 [-1, 1] (host; each code maps to the center
    of its quantization cell)."""
    u = (~u8.astype(np.int32)) & 0xFF
    seg = (u >> 4) & 0x7
    mant = u & 0xF
    # restore the implicit MSB and the half-cell midpoint, remove the bias
    mag14 = ((mant + 16) << (seg + 1)) + (1 << seg) - 33
    x14 = np.where(u & 0x80, -mag14, mag14)  # bit 7 of ~byte: negative
    return (x14 << 2).astype(np.float32) / 32767.0


_MULAW_LUT: dict = {}


def mulaw_lut(dtype=np.float32) -> np.ndarray:
    """256-entry mu-law expansion table (float32 [-1, 1] or int16 PCM):
    expanding a clip is one gather."""
    key = np.dtype(dtype).name
    if key not in _MULAW_LUT:
        f32 = mulaw_decode_np(np.arange(256, dtype=np.uint8))
        if key == "int16":
            _MULAW_LUT[key] = np.round(f32 * 32767.0).astype(np.int16)
        else:
            _MULAW_LUT[key] = f32.astype(dtype)
    return _MULAW_LUT[key]
