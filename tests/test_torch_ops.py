# -*- coding: utf-8 -*-
"""PyTorch port: ``ops/`` (alignment, STFT, the iSTFT wrapper) against the
JAX package's ops on seeded inputs.

The iSTFT kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``istft_oa_plain`` there); here the wrapper takes the plain path
because its tensors lie on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.model.kokoro import _fit_durations as jax_fit
from illufly_tts_tpu.ops import align as jalign
from illufly_tts_tpu.ops import stft as jstft
from illufly_tts_tpu_torch.model.kokoro import _fit_durations
from illufly_tts_tpu_torch.ops import align, istft_oa as oa, stft

torch.set_num_threads(2)


def _durations(seed=0, batch=3, tokens=9):
    rng = np.random.RandomState(seed)
    dur = rng.randint(0, 6, (batch, tokens)).astype(np.int32)
    dur[-1] = 0  # an all-padding row
    return dur


@pytest.mark.parametrize("frames", [1, 17, 64])
def test_align_matches_jax(frames):
    dur = _durations()
    t_dur = torch.from_numpy(dur)
    np.testing.assert_array_equal(
        align.frame_token_indices(t_dur, frames).numpy(),
        np.asarray(jalign.frame_token_indices(jnp.asarray(dur), frames)))
    feats = np.random.RandomState(1).randn(3, 9, 4).astype(np.float32)
    np.testing.assert_array_equal(
        align.expand_by_duration(torch.from_numpy(feats), t_dur,
                                 frames).numpy(),
        np.asarray(jalign.expand_by_duration(jnp.asarray(feats),
                                             jnp.asarray(dur), frames)))
    np.testing.assert_array_equal(
        align.frame_mask(t_dur, frames).numpy(),
        np.asarray(jalign.frame_mask(jnp.asarray(dur), frames)))


@pytest.mark.parametrize("budget", [5, 20, 200])
def test_fit_durations_matches_jax(budget):
    dur = _durations(2)
    np.testing.assert_array_equal(
        _fit_durations(torch.from_numpy(dur), budget).numpy(),
        np.asarray(jax_fit(jnp.asarray(dur), budget)))


def _magphase_both(x):
    mag, ph = stft.stft_magphase(torch.from_numpy(x), 20, 5)
    jmag, jph = jstft.stft_magphase(jnp.asarray(x), 20, 5)
    return mag.numpy(), ph.numpy(), np.asarray(jmag), np.asarray(jph)


def test_stft_magphase_matches_jax():
    x = np.random.RandomState(3).randn(2, 400).astype(np.float32)
    mag, ph, jmag, jph = _magphase_both(x)
    np.testing.assert_allclose(mag, jmag, atol=1e-5, rtol=1e-5)
    # compare phase on the circle: ±π are the same angle
    np.testing.assert_allclose(np.cos(ph), np.cos(jph), atol=2e-5)
    np.testing.assert_allclose(np.sin(ph), np.sin(jph), atol=2e-5)


def test_stft_magphase_zero_and_dead_bins():
    """Zero input: every bin dead -> phase exactly 0, mag sqrt(1e-9).
    A constant: DC alive, the sine rows' -0.0 canonicalized, so the Nyquist
    and DC phases land on the same branch in both packages."""
    zero = np.zeros((1, 100), np.float32)
    mag, ph, jmag, jph = _magphase_both(zero)
    assert not ph.any() and not np.signbit(ph).any()
    np.testing.assert_array_equal(ph, jph)
    np.testing.assert_allclose(mag, np.sqrt(1e-9), rtol=1e-6)
    const = np.full((1, 100), -0.5, np.float32)
    mag, ph, jmag, jph = _magphase_both(const)
    np.testing.assert_array_equal(ph[..., 0], jph[..., 0])  # DC: ±π side
    np.testing.assert_allclose(ph[..., 0], np.pi, rtol=1e-6)
    np.testing.assert_allclose(mag, jmag, atol=1e-6)


def test_overlap_add_matches_jax():
    frames = np.random.RandomState(4).randn(2, 7, 20).astype(np.float32)
    np.testing.assert_allclose(
        stft.overlap_add(torch.from_numpy(frames), 5).numpy(),
        np.asarray(jstft.overlap_add(jnp.asarray(frames), 5)), atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        stft.overlap_add(torch.from_numpy(frames), 3)


def _magphase_inputs(frames, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    mag = np.abs(rng.randn(batch, frames, 11)).astype(np.float32)
    phase = ((rng.rand(batch, frames, 11) * 2 - 1) * np.pi).astype(np.float32)
    return mag, phase


@pytest.mark.parametrize("frames", [64, 200, 1024])
def test_istft_oa_plain_matches_jax_istft(frames):
    mag, phase = _magphase_inputs(frames)
    ref = jstft.istft(jnp.asarray(mag), jnp.asarray(phase), 20, 5)
    out = oa.istft_oa_plain(torch.from_numpy(mag), torch.from_numpy(phase))
    assert tuple(out.shape) == (2, frames * 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :frames * 5],
                               atol=1e-4)


def test_istft_oa_plain_matches_pallas_interpret():
    from illufly_tts_tpu.ops.pallas.istft_oa import istft_pallas

    mag, phase = _magphase_inputs(64, seed=1)
    ref = istft_pallas(jnp.asarray(mag), jnp.asarray(phase), 20, 5,
                       frames_per_block=64, interpret=True)
    out = oa.istft_oa_plain(torch.from_numpy(mag), torch.from_numpy(phase))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_istft_oa_wrapper_on_cpu_takes_plain_path():
    mag, phase = _magphase_inputs(50, seed=2)
    before = oa.launches
    out = oa.istft_oa(torch.from_numpy(mag), torch.from_numpy(phase))
    assert oa.launches == before  # the plain path launches nothing
    np.testing.assert_array_equal(
        out.numpy(),
        oa.istft_oa_plain(torch.from_numpy(mag),
                          torch.from_numpy(phase)).numpy())
    with pytest.raises(ValueError, match="K=10"):
        oa.istft_oa(torch.zeros(1, 8, 10), torch.zeros(1, 8, 10))
    with pytest.raises(ValueError, match="shape"):
        oa.istft_oa(torch.zeros(1, 8, 11), torch.zeros(1, 9, 11))
    with pytest.raises(ValueError, match="built for"):
        oa.istft_oa(torch.zeros(1, 8, 9), torch.zeros(1, 8, 9), 16, 4)


def test_istft_oa_kernel_tables():
    """The kernel's by-value tables: windowed bases whose first column
    (window value 0) is exactly zero, so sample 0 stays 0 under the 1e8
    envelope reciprocal; the steady envelope equals the plain version's."""
    t = oa._tables()
    cw = t[:220].reshape(11, 20)
    sw = t[220:440].reshape(11, 20)
    assert not cw[:, 0].any() and not sw[:, 0].any()
    env = stft.overlap_add(torch.from_numpy(
        np.broadcast_to(stft.hann(20) ** 2, (1, 8, 20)).astype(np.float32)
    ), 5)[0].numpy()
    np.testing.assert_allclose(t[455:460], 1.0 / env[15:20], rtol=1e-6)
    np.testing.assert_allclose(t[441:455], 1.0 / env[1:15], rtol=1e-5)
