# -*- coding: utf-8 -*-
"""Tiny-window STFT/iSTFT as basis products (PyTorch port of
``illufly_tts_tpu/ops/stft.py``).

The iSTFTNet head uses n_fft=20, hop=5. Both transforms are products with
precomputed real DFT bases (numpy, host), plus overlap-add with torch.istft
style window-envelope normalization. These are the plain versions; the
Generator's inverse goes through the kernel wrapper in ``ops/istft_oa.py``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)  # periodic


@lru_cache(maxsize=None)
def _bases(n_fft: int):
    """(fwd_cos, fwd_sin [K, n_fft], inv_cos, inv_sin [K, n_fft]), numpy
    float32."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft          # [n_fft, K]
    fwd_cos = np.cos(angle).T                              # [K, n_fft]
    fwd_sin = -np.sin(angle).T
    # snap analytically-zero entries (DC/Nyquist sine rows) to +0.0: the
    # sign of a ±0 imaginary part decides atan2's ±π branch
    fwd_cos = np.where(np.abs(fwd_cos) < 1e-12, 0.0, fwd_cos)
    fwd_sin = np.where(np.abs(fwd_sin) < 1e-12, 0.0, fwd_sin)
    # inverse: x[n] = sum_k w_k (Re cos - Im sin), w = 2/N except DC/Nyquist
    w = np.full(n_fft // 2 + 1, 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    inv_cos = np.cos(angle) * w                            # [n_fft, K]
    inv_sin = -np.sin(angle) * w
    return (
        np.asarray(fwd_cos, np.float32),
        np.asarray(fwd_sin, np.float32),
        np.asarray(inv_cos.T, np.float32),                 # [K, n_fft]
        np.asarray(inv_sin.T, np.float32),
    )


@lru_cache(maxsize=None)
def _table(kind: str, n_fft: int, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A basis or window as a tensor, uploaded once per device: a fresh
    upload from pageable host memory would wait for the stream. Made
    outside inference mode, so a table first made while serving can enter
    a graph that autograd records later (training in the same process)."""
    fwd_cos, fwd_sin, inv_cos, inv_sin = _bases(n_fft)
    arr = {"fwd_cos_t": fwd_cos.T, "fwd_sin_t": fwd_sin.T, "inv_cos": inv_cos,
           "inv_sin": inv_sin, "hann": hann(n_fft)}[kind]
    with torch.inference_mode(False):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                               device=device)


def _t(kind: str, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return _table(kind, n_fft, like.dtype, like.device)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """x [B, L] -> frames [B, F, n_fft], F = (L - n_fft)//hop + 1."""
    return x.unfold(-1, n_fft, hop)


def stft_magphase(x: torch.Tensor, n_fft: int, hop: int):
    """x [B, L] -> (mag [B, F, K], phase [B, F, K]) with a hann window."""
    frames = frame_signal(x, n_fft, hop) * _t("hann", n_fft, x)
    re = frames @ _t("fwd_cos_t", n_fft, x)
    im = frames @ _t("fwd_sin_t", n_fft, x)
    power = re * re + im * im
    mag = torch.sqrt(power + 1e-9)
    # canonicalize -0.0 -> +0.0 so atan2(0, re<0) lands on +pi everywhere
    im = torch.where(im == 0.0, torch.zeros_like(im), im)
    # dead bins (unvoiced harmonic source): (re, im) = (1, 0) there — the
    # same forward value (atan2(0, 1) = 0)
    dead = power < 1e-12
    re = torch.where(dead, torch.ones_like(re), re)
    im = torch.where(dead, torch.zeros_like(im), im)
    return mag, torch.atan2(im, re)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """frames [B, F, W] -> [B, (F - 1)*hop + W] via shifted partial sums.

    Requires hop | W: each frame is covered by exactly W/hop hop-sized
    chunks."""
    batch, num_frames, win = frames.shape
    if win % hop:
        raise ValueError(
            f"overlap_add requires hop ({hop}) to divide the window "
            f"({win}); {win % hop} trailing samples per frame would be "
            "silently dropped"
        )
    y = frames.new_zeros((batch, (num_frames - 1) * hop + win))
    for j in range(win // hop):
        part = frames[:, :, j * hop:(j + 1) * hop].reshape(batch, -1)
        y[:, j * hop:j * hop + num_frames * hop] += part
    return y


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int):
    """(mag, phase) [B, F, K] -> audio [B, (F - 1)*hop + n_fft].

    torch.istft semantics: windowed frames overlap-added, normalized by the
    summed squared window envelope."""
    re = mag * torch.cos(phase)
    im = mag * torch.sin(phase)
    frames = re @ _t("inv_cos", n_fft, mag) + im @ _t("inv_sin", n_fft, mag)
    win = _t("hann", n_fft, mag)
    audio = overlap_add(frames * win, hop)
    num_frames = mag.shape[1]
    env = overlap_add((win * win).expand(1, num_frames, n_fft), hop)
    return audio / env.clamp(min=1e-8)
