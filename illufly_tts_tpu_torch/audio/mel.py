# -*- coding: utf-8 -*-
"""Mel spectrogram (numpy) for parity metrics (mel-L1 between pipelines),
per the BASELINE.md fidelity target. librosa is unavailable; this is a
standard slaney-style mel filterbank implementation."""
from __future__ import annotations

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    fmax = fmax or sample_rate / 2
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    freqs = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, ctr):
            if ctr > lo:
                fb[i, j] = (j - lo) / (ctr - lo)
        for j in range(ctr, hi):
            if hi > ctr:
                fb[i, j] = (hi - j) / (hi - ctr)
    return fb


def mel_spectrogram(
    audio: np.ndarray,
    sample_rate: int = 24000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
) -> np.ndarray:
    """audio [L] -> log-mel [n_mels, F]."""
    audio = np.asarray(audio, np.float32)
    if audio.size < n_fft:
        audio = np.pad(audio, (0, n_fft - audio.size))
    # PERIODIC hann + the same log floor as the jax train path
    # (audio/mel_jax.py, ops/stft.py) so train-time and eval-time mel-L1
    # are numerically the same metric — np.hanning is the symmetric
    # variant and silently disagreed
    window = 0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n_fft) / n_fft
    )
    n_frames = 1 + (audio.size - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        audio,
        shape=(n_frames, n_fft),
        strides=(audio.strides[0] * hop, audio.strides[0]),
    )
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    fb = mel_filterbank(sample_rate, n_fft, n_mels)
    mel = fb @ spec.T
    return np.log(np.maximum(mel, 1e-5))


def mel_l1(a: np.ndarray, b: np.ndarray, **kw) -> float:
    """Mean absolute log-mel distance between two waveforms."""
    ma = mel_spectrogram(a, **kw)
    mb = mel_spectrogram(b, **kw)
    f = min(ma.shape[1], mb.shape[1])
    return float(np.abs(ma[:, :f] - mb[:, :f]).mean())
