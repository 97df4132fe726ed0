# -*- coding: utf-8 -*-
"""Fused iSTFT head of the vocoder: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``illufly_tts_tpu/ops/pallas/istft_oa.py::
istft_pallas``: (mag, phase) ``[B, F, K=11]`` -> audio ``[B, F * 5]``, the
torch.istft-style inverse of ``ops/stft.py`` truncated to ``F * hop``
samples (n_fft=20, hop=5).

The kernel (``csrc/istft_oa.cu``) is memory-bound: it must read mag and
phase once and write the audio once. For the main path's largest shape,
``[8, 61440, 11]`` (B=8 at frame bucket 512), that is 43.3 MB read and
9.8 MB written, about 16 us at the H100's 3.35 TB/s; its ~88 FMAs per
output sample are far below the card's compute balance. The design keeps
the [B, F, 20] frame tensor of the plain version out of device memory:
each block turns its tile of frames into audio in shared memory.

``istft_oa`` launches the kernel for CUDA tensors (or raises) and counts
the launch in ``launches``; it runs ``istft_oa_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .stft import _bases, hann, istft

N_FFT = 20
HOP = 5

# kernel launches since the last reset (plain-version calls do not count)
launches = 0


def istft_oa_plain(mag: torch.Tensor, phase: torch.Tensor,
                   n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """PyTorch ops equal to ``ops/stft.py::istft(...)[:, :F * hop]``."""
    return istft(mag, phase, n_fft, hop)[:, : mag.shape[1] * hop]


@lru_cache(maxsize=None)
def _tables() -> np.ndarray:
    """The kernel's by-value tables (``struct Tables`` in the source):
    windowed inverse bases [11, 20] x 2, then 1/envelope for samples 0..14
    and for every later sample (by sample % hop)."""
    _, _, inv_cos, inv_sin = _bases(N_FFT)
    win = hann(N_FFT)
    cw = np.asarray(inv_cos, np.float32) * win.astype(np.float32)[None, :]
    sw = np.asarray(inv_sin, np.float32) * win.astype(np.float32)[None, :]
    chunks = N_FFT // HOP
    env = np.zeros(chunks * HOP)  # samples 0 .. 19, float64
    for f in range(chunks):
        env[f * HOP:] += (win * win)[: (chunks - f) * HOP]
    env_inv = 1.0 / np.maximum(env, 1e-8)
    return np.ascontiguousarray(np.concatenate([
        cw.ravel(), sw.ravel(), env_inv[: (chunks - 1) * HOP],
        env_inv[(chunks - 1) * HOP:],
    ]).astype(np.float32))


@lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("istft_oa")
    lib.istft_oa_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.istft_oa_f32.restype = ctypes.c_int
    lib.istft_oa_table_floats.restype = ctypes.c_int
    if lib.istft_oa_table_floats() != _tables().size:
        raise RuntimeError("istft_oa: table layout differs from the source")
    return lib


def istft_oa(mag: torch.Tensor, phase: torch.Tensor, n_fft: int = N_FFT,
             hop: int = HOP) -> torch.Tensor:
    """(mag, phase) [B, F, n_fft//2+1] f32 -> audio [B, F * hop] f32."""
    global launches
    if mag.dim() != 3 or mag.shape != phase.shape:
        raise ValueError(f"istft_oa: mag {tuple(mag.shape)} and phase "
                         f"{tuple(phase.shape)} must be one [B, F, K] shape")
    if mag.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"istft_oa: K={mag.shape[-1]} != n_fft//2+1 "
                         f"({n_fft // 2 + 1})")
    if (n_fft, hop) != (N_FFT, HOP):
        raise ValueError(f"istft_oa: (n_fft, hop)=({n_fft}, {hop}); the "
                         f"kernel is built for ({N_FFT}, {HOP})")
    if mag.device.type == "cpu" and phase.device.type == "cpu":
        return istft_oa_plain(mag, phase, n_fft, hop)
    if not (mag.is_cuda and phase.device == mag.device):
        raise ValueError("istft_oa: mag and phase must be on one CUDA device")
    if mag.dtype != torch.float32 or phase.dtype != torch.float32:
        raise TypeError("istft_oa kernel takes float32")
    if not (mag.is_contiguous() and phase.is_contiguous()):
        raise ValueError("istft_oa kernel takes contiguous [B, F, K]")
    batch, frames, _ = mag.shape
    if batch == 0 or frames == 0 or batch > 65535:
        raise ValueError(f"istft_oa kernel: batch {batch}, frames {frames}")
    lib = _library()
    out = torch.empty((batch, frames * hop), dtype=torch.float32,
                      device=mag.device)
    stream = torch.cuda.current_stream(mag.device).cuda_stream
    rc = lib.istft_oa_f32(
        mag.data_ptr(), phase.data_ptr(), out.data_ptr(), batch, frames,
        _tables().ctypes.data, stream,
    )
    if rc != 0:
        raise RuntimeError(f"istft_oa kernel launch failed: cudaError {rc}")
    launches += 1
    return out
