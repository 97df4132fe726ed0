# -*- coding: utf-8 -*-
"""Differentiable (PyTorch) mel-spectrogram and multi-resolution STFT
losses: the port of ``illufly_tts_tpu/audio/mel_jax.py``.

Training-side counterpart of ``audio/mel.py`` (numpy, metrics only), with
the same slaney-style filterbank, so train-time and eval-time mel-L1 agree.
The STFT is ``ops/stft.py::stft_magphase``, whose dead-bin guard gives a
zero gradient where the JAX one does. Used by ``training/step.py`` for the
real-data objective (mel L1 + multi-resolution STFT, the StyleTTS2
reconstruction terms)."""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.stft import stft_magphase
from .mel import mel_filterbank


@lru_cache(maxsize=8)
def _fb(sample_rate: int, n_fft: int, n_mels: int, device: torch.device):
    """The filterbank [M, bins] as an f32 tensor, uploaded once per device
    (outside inference mode, as ``ops/stft.py``'s tables)."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels).astype(np.float32)
    with torch.inference_mode(False):
        return torch.from_numpy(fb).to(device)


def log_mel(audio: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
            hop: int = 256, n_mels: int = 80) -> torch.Tensor:
    """audio [B, L] -> log-mel [B, n_mels, F] (differentiable)."""
    mag, _ = stft_magphase(audio, n_fft, hop)   # [B, F, bins]
    power = torch.square(mag)
    fb = _fb(sample_rate, n_fft, n_mels, audio.device)
    mel = torch.einsum("mf,btf->bmt", fb, power)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_l1(a: torch.Tensor, b: torch.Tensor,
           sample_rate: int = 24000) -> torch.Tensor:
    """Mean |log-mel difference| between waveform batches [B, L]."""
    return torch.mean(torch.abs(log_mel(a, sample_rate)
                                - log_mel(b, sample_rate)))


def multi_res_stft_loss(
    a: torch.Tensor,
    b: torch.Tensor,
    resolutions: Sequence[Tuple[int, int]] = (
        (512, 128), (1024, 256), (2048, 512),
    ),
    sc_weight: float = 0.1,
) -> torch.Tensor:
    """Log-magnitude L1 + down-weighted spectral convergence, summed over
    resolutions (the Parallel-WaveGAN / StyleTTS2 auxiliary loss). The
    convergence term is linear in magnitude: against this model's unbounded
    exp-magnitude head it dominates early training and diverges from a
    random init, so it rides at 0.1 while the log terms carry the
    gradient."""
    total = 0.0
    for n_fft, hop in resolutions:
        mag_a, _ = stft_magphase(a, n_fft, hop)
        mag_b, _ = stft_magphase(b, n_fft, hop)
        sc = torch.linalg.vector_norm(mag_a - mag_b) / torch.clamp(
            torch.linalg.vector_norm(mag_b), min=1e-6)
        log_l1 = torch.mean(torch.abs(
            torch.log(torch.clamp(mag_a, min=1e-6))
            - torch.log(torch.clamp(mag_b, min=1e-6))))
        total = total + sc_weight * sc + log_l1
    return total / len(resolutions)
