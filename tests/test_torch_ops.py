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


def _head_input(frames, batch=2, seed=0, scale=2.0):
    """conv_post-like output [B, 22, L]: log-magnitudes then raw phases."""
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 22, frames) * scale).astype(np.float32)


def _jax_head(x_cl):
    """The JAX Generator's head on channels-last x [B, L, 22]: exp(clip),
    pi * sin, then the Pallas iSTFT in interpret mode."""
    from illufly_tts_tpu.ops.pallas.istft_oa import istft_pallas

    mag = jnp.exp(jnp.clip(x_cl[..., :11], -12.0, 8.0))
    phase = np.pi * jnp.sin(x_cl[..., 11:])
    return np.asarray(istft_pallas(mag, phase, 20, 5, interpret=True))


@pytest.mark.parametrize("frames,scale", [
    (200, 2.0),  # not a multiple of 128
    (37, 2.0),   # shorter than one kernel tile
    (64, 9.0),   # log-magnitudes beyond both clip edges (-12, 8)
])
def test_istft_head_plain_matches_jax_head(frames, scale):
    x = _head_input(frames, seed=frames, scale=scale)
    if scale > 8:
        assert (x[:, :11] < -12).any() and (x[:, :11] > 8).any()
    ref = _jax_head(jnp.asarray(x.transpose(0, 2, 1)))
    out = oa.istft_head_plain(torch.from_numpy(x))
    assert tuple(out.shape) == (2, frames * 5)
    tol = 1e-4 * (1.0 + np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)


def _eager_head(x):
    """The Generator's head before the fused kernel: clamp/exp, pi * sin,
    channels-last copies, then the polar iSTFT."""
    mag = torch.exp(torch.clamp(x[:, :11], -12.0, 8.0))
    phase = np.pi * torch.sin(x[:, 11:])
    return oa.istft_oa_plain(mag.transpose(1, 2).contiguous(),
                             phase.transpose(1, 2).contiguous())


def test_istft_head_wrapper_on_cpu_takes_plain_path():
    x = torch.from_numpy(_head_input(50, seed=5))
    before = oa.launches
    out = oa.istft_head(x)
    assert oa.launches == before  # the plain path launches nothing
    torch.testing.assert_close(out, _eager_head(x), rtol=0, atol=0)
    assert float(out[:, 0].abs().max()) == 0.0  # sample 0: window is 0


@pytest.mark.parametrize("shape,n_fft,hop,match", [
    ((1, 21, 8), 20, 5, "must be"),    # channels != 22
    ((1, 24, 8), 20, 5, "must be"),
    ((22, 8), 20, 5, "must be"),       # rank 2
    ((1, 1, 22, 8), 20, 5, "must be"),  # rank 4
    ((1, 22, 8), 16, 4, "built for"),
    ((1, 22, 8), 20, 4, "built for"),
])
def test_istft_head_wrapper_raises(shape, n_fft, hop, match):
    with pytest.raises(ValueError, match=match):
        oa.istft_head(torch.zeros(shape), n_fft, hop)


def test_istft_head_nan_propagates():
    """A NaN in a frame's log-magnitude or raw phase gives NaN in exactly
    the samples that frame covers (5f .. 5f + 19), as the eager head does:
    the clip keeps NaN (the kernel's clip is written to match)."""
    x = _head_input(40, batch=1, seed=6)
    x[0, 3, 5] = np.nan    # log-magnitude of frame 5
    x[0, 15, 30] = np.nan  # raw phase of frame 30
    xt = torch.from_numpy(x)
    out = oa.istft_head(xt)
    nan = torch.isnan(out[0])
    assert torch.equal(nan, torch.isnan(_eager_head(xt)[0]))
    want = np.zeros(200, bool)
    for f in (5, 30):
        want[5 * f: 5 * f + 20] = True
    np.testing.assert_array_equal(nan.numpy(), want)


def _kernel_core_emulation(re, im):
    """numpy float32 copy of the CUDA kernel's core on re/im [B, F, 11]:
    the bases' even/odd fold about n = 10 (A over k = 0..10, S over
    k = 1..9), frame[0] = 0 * A[1], then the 4-frame overlap-add and the
    1/envelope tables, all from ``_tables()``."""
    t = oa._tables()
    cw, sw = t[:220].reshape(11, 20), t[220:440].reshape(11, 20)
    env_head, env_steady = t[440:455], t[455:460]
    batch, frames, _ = re.shape
    fr = np.zeros((batch, frames, 20), np.float32)
    sym = {n: re @ cw[:, n] for n in range(1, 11)}
    asym = {n: im[..., 1:10] @ sw[1:10, n] for n in range(1, 10)}
    fr[..., 0] = np.float32(0) * sym[1]
    for n in range(1, 10):
        fr[..., n] = sym[n] + asym[n]
        fr[..., 20 - n] = sym[n] - asym[n]
    fr[..., 10] = sym[10]
    pad = np.concatenate([np.zeros((batch, 3, 20), np.float32), fr], axis=1)
    y = (pad[:, 3:, 0:5] + pad[:, 2:-1, 5:10] + pad[:, 1:-2, 10:15]
         + pad[:, :-3, 15:20]).reshape(batch, frames * 5)
    env = np.tile(env_steady, frames)
    env[:15] = env_head[: frames * 5]
    return y * env


@pytest.mark.parametrize("frames", [1, 3, 37, 130])
def test_istft_kernel_core_fold_matches_plain(frames):
    """The kernel's arithmetic (folded bases, dropped float-zero basis
    entries, exact zero at sample 0) against the plain polar iSTFT."""
    mag, phase = _magphase_inputs(frames, seed=frames)
    mag[0, frames // 2, 4] = np.nan
    re = (mag * np.cos(phase)).astype(np.float32)
    im = (mag * np.sin(phase)).astype(np.float32)
    out = _kernel_core_emulation(re, im)
    ref = oa.istft_oa_plain(torch.from_numpy(mag),
                            torch.from_numpy(phase)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    if frames // 2 > 0:
        assert (out[:, 0] == 0).all()
