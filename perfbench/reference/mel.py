"""Log-mel distance between two waveforms, for the comparison of audio
whose overall gain is not defined to the precision compared (the served
pcm16 is scaled by its peak, and with random weights the peak is an
ill-conditioned sample at the utterance's edge)."""
from __future__ import annotations

import numpy as np

N_FFT, HOP, N_MELS, RATE = 1024, 256, 80, 24000


def _filterbank() -> np.ndarray:
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    mels = np.linspace(0.0, to_mel(RATE / 2), N_MELS + 2)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    bins = np.floor((N_FFT + 1) * hz / RATE).astype(int)
    fb = np.zeros((N_MELS, N_FFT // 2 + 1))
    for i in range(N_MELS):
        lo, mid, hi = bins[i], bins[i + 1], bins[i + 2]
        if mid > lo:
            fb[i, lo:mid] = (np.arange(lo, mid) - lo) / (mid - lo)
        if hi > mid:
            fb[i, mid:hi] = (hi - np.arange(mid, hi)) / (hi - mid)
    return fb


def log_mel(audio: np.ndarray) -> np.ndarray:
    """[L] -> [frames, N_MELS] natural-log mel power (floor 1e-5)."""
    x = np.asarray(audio, np.float64)
    if x.size < N_FFT:
        x = np.pad(x, (0, N_FFT - x.size))
    count = 1 + (x.size - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(count)[:, None]
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)
    power = np.abs(np.fft.rfft(x[idx] * win, axis=-1)) ** 2
    return np.log(np.maximum(power @ _filterbank().T, 1e-5))


def gain_matched_l1(got: np.ndarray, want: np.ndarray) -> float:
    """Mean |log-mel difference| after removing its mean (a gain)."""
    d = log_mel(got) - log_mel(want)
    return float(np.abs(d - d.mean()).mean())
