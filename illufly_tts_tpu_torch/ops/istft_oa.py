# -*- coding: utf-8 -*-
"""Fused iSTFT head of the vocoder: CUDA kernel wrappers + plain versions.

Replaces the TPU kernel ``illufly_tts_tpu/ops/pallas/istft_oa.py::
istft_pallas``: (mag, phase) ``[B, F, K=11]`` -> audio ``[B, F * 5]``, the
torch.istft-style inverse of ``ops/stft.py`` truncated to ``F * hop``
samples (n_fft=20, hop=5). Two entries share one kernel source
(``csrc/istft_oa.cu``):

- ``istft_head(x)``: conv_post's raw output ``x [B, 22, L]``, channels
  first; mag = exp(clip(x[:, :11], -12, 8)) and phase = pi sin(x[:, 11:])
  are computed inside the kernel. The Generator's path: no mag, phase or
  transposed tensor reaches device memory.
- ``istft_oa(mag, phase)``: the TPU kernel's own interface.

The kernel is memory-bound: it must read its input once and write the audio
once. For the main path's largest timed shape, ``[8, 22, 61440]`` (B=8 at
frame bucket 512), that is 43.3 MB read and 9.8 MB written, about 16 us at
the H100's 3.35 TB/s. Each wrapper launches the kernel for CUDA tensors (or
raises) and counts the launch in ``launches`` (one counter for both
entries: one launch per Generator pass); for CPU tensors it runs its plain
version. On CUDA the launch goes through ``ops/kernel_grad.py::
kernel_call``: where autograd records, the gradient of the head's x, or of
mag and phase, comes from the plain version recomputed in the backward.
"""
from __future__ import annotations

import ctypes
import math
import threading
from functools import lru_cache

import numpy as np
import torch

from .kernel_grad import kernel_call
from .stft import _bases, hann, istft

N_FFT = 20
HOP = 5
K = N_FFT // 2 + 1

# kernel launches since the last reset (plain-version calls do not count),
# bumped under a lock: the scheduler's worker threads launch concurrently
launches = 0
_launches_lock = threading.Lock()


def count_launch() -> None:
    """Add one launch to ``launches``."""
    global launches
    with _launches_lock:
        launches += 1


def istft_oa_plain(mag: torch.Tensor, phase: torch.Tensor,
                   n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """PyTorch ops equal to ``ops/stft.py::istft(...)[:, :F * hop]``."""
    return istft(mag, phase, n_fft, hop)[:, : mag.shape[1] * hop]


def istft_head_plain(x: torch.Tensor, n_fft: int = N_FFT,
                     hop: int = HOP) -> torch.Tensor:
    """conv_post output [B, n_fft + 2, L] -> audio [B, L * hop]: the
    Generator's eager head (clamp/exp, pi * sin, channels last) and
    ``istft_oa_plain``."""
    k = n_fft // 2 + 1
    mag = torch.exp(torch.clamp(x[:, :k], -12.0, 8.0))
    phase = math.pi * torch.sin(x[:, k:])
    return istft_oa_plain(mag.transpose(1, 2), phase.transpose(1, 2), n_fft,
                          hop)


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
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.istft_head_f32.argtypes = [ptr, ptr, num, num, ptr, ptr]
    lib.istft_oa_f32.argtypes = [ptr, ptr, ptr, num, num, ptr, ptr]
    lib.istft_head_f32.restype = ctypes.c_int
    lib.istft_oa_f32.restype = ctypes.c_int
    lib.istft_oa_table_floats.restype = ctypes.c_int
    if lib.istft_oa_table_floats() != _tables().size:
        raise RuntimeError("istft_oa: table layout differs from the source")
    return lib


def _check(fn: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{fn}: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{fn} kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn} kernel takes contiguous inputs")


def _launch(entry, inputs, batch: int, frames: int) -> torch.Tensor:
    """Run ``entry`` (a C entry point) on ``inputs`` -> audio [B, F * 5]."""
    dev = inputs[0].device
    out = torch.empty((batch, frames * HOP), dtype=torch.float32, device=dev)
    rc = entry(*(t.data_ptr() for t in inputs), out.data_ptr(), batch,
               frames, _tables().ctypes.data,
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"istft_oa kernel launch failed: cudaError {rc}")
    return out


def _call(entry, plain, batch: int, frames: int,
          *inputs: torch.Tensor) -> torch.Tensor:
    """Launch ``entry`` on ``inputs`` and count it; where autograd records,
    the backward differentiates ``plain`` (``kernel_call``)."""
    def launch(*tensors):
        out = _launch(entry, tensors, batch, frames)
        count_launch()
        return out

    return kernel_call(launch, plain, *inputs)


def istft_head(x: torch.Tensor, n_fft: int = N_FFT,
               hop: int = HOP) -> torch.Tensor:
    """conv_post output x [B, n_fft + 2, L] f32 -> audio [B, L * hop] f32."""
    if (n_fft, hop) != (N_FFT, HOP):
        raise ValueError(f"istft_head: (n_fft, hop)=({n_fft}, {hop}); the "
                         f"kernel is built for ({N_FFT}, {HOP})")
    if x.dim() != 3 or x.shape[1] != 2 * K:
        raise ValueError(f"istft_head: x {tuple(x.shape)} must be "
                         f"[B, {2 * K}, L]")
    if x.device.type == "cpu":
        return istft_head_plain(x, n_fft, hop)
    _check("istft_head", x)
    batch, _, frames = x.shape
    if batch == 0 or frames == 0:
        raise ValueError(f"istft_head kernel: batch {batch}, frames {frames}")
    return _call(_library().istft_head_f32, istft_head_plain, batch, frames,
                 x)


def istft_oa(mag: torch.Tensor, phase: torch.Tensor, n_fft: int = N_FFT,
             hop: int = HOP) -> torch.Tensor:
    """(mag, phase) [B, F, n_fft//2+1] f32 -> audio [B, F * hop] f32."""
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
    _check("istft_oa", mag, phase)
    batch, frames, _ = mag.shape
    if batch == 0 or frames == 0:
        raise ValueError(f"istft_oa kernel: batch {batch}, frames {frames}")
    return _call(_library().istft_oa_f32, istft_oa_plain, batch, frames, mag,
                 phase)
