# -*- coding: utf-8 -*-
"""PyTorch port: KokoroModel stage A and stage B against the JAX model on
``tiny_config`` with shared parameters (the JAX random init, seed 123),
on a batch with a full row, a padded row and an all-padding row.

Both stage Bs get JAX's quantized durations, so rounding cannot split
them; the JAX side runs its jnp iSTFT (``use_pallas_istft=False``), the
port its iSTFT wrapper's plain version (CPU tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model.kokoro import KokoroModel as JaxModel
from illufly_tts_tpu.model.kokoro import _fit_durations as jax_fit
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import load_flax_params
from tests.test_model import tiny_config
from tests.test_torch_params import numpy_tree, port_config

torch.set_num_threads(2)

SEED = 123
FRAMES = 64


@pytest.fixture(scope="module")
def models():
    jsynth = JaxSynthesizer(tiny_config(), seed=SEED)
    params = numpy_tree(jsynth.params)
    port = KokoroModel(port_config()).eval()
    load_flax_params(port, params)
    return jsynth.model, params, port


def _batch(cfg, tokens=16, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.array([tokens, tokens - 5, 0])
    mask = (np.arange(tokens)[None, :] < lengths[:, None]).astype(np.float32)
    ids = (rng.randint(1, cfg.n_token, (3, tokens)) * mask).astype(np.int32)
    ref = (rng.randn(3, 2 * cfg.style_dim) * 0.1).astype(np.float32)
    speed = np.array([1.0, 1.3, 1.0], np.float32)
    return ids, mask, ref, speed


@pytest.fixture(scope="module")
def stage_a(models):
    jmodel, params, port = models
    ids, mask, ref, speed = _batch(tiny_config())
    run = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, method=JaxModel.encode_durations))
    duration, d = run(params, ids, mask, ref, speed)
    pred_dur = JaxModel.quantize_durations(duration, jnp.asarray(mask))
    with torch.no_grad():
        t_duration, t_d = port.encode_durations(
            torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(ref), torch.from_numpy(speed))
    return (ids, mask, ref), (np.array(duration), np.array(d),
                              np.array(pred_dur)), (t_duration, t_d)


def test_stage_a_matches_jax(stage_a):
    _, (duration, d, pred_dur), (t_duration, t_d) = stage_a
    np.testing.assert_allclose(t_duration.numpy(), duration, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(t_d.numpy(), d, atol=1e-5, rtol=1e-4)
    t_pred = KokoroModel.quantize_durations(
        t_duration, torch.from_numpy(stage_a[0][1]))
    np.testing.assert_array_equal(t_pred.numpy(), pred_dur)
    assert not pred_dur[2].any()  # the all-padding row


@pytest.mark.parametrize("pcm16", [False, True])
def test_stage_b_matches_jax(models, stage_a, pcm16):
    jmodel, params, port = models
    (ids, mask, ref), (_, d, pred_dur), _ = stage_a
    fitted = np.array(jax_fit(jnp.asarray(pred_dur), FRAMES))
    run = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, FRAMES, pcm16=pcm16, method=JaxModel.decode_frames))
    audio, fmask = run(params, ids, mask, d, fitted, ref)
    with torch.no_grad():
        t_audio, t_fmask = port.decode_frames(
            torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(d), torch.from_numpy(fitted),
            torch.from_numpy(ref), FRAMES, pcm16=pcm16)
    audio, t_audio = np.asarray(audio), t_audio.numpy()
    np.testing.assert_array_equal(t_fmask.numpy(), np.asarray(fmask))
    assert t_audio.shape == audio.shape == (3, FRAMES * 600)
    assert t_audio.dtype == audio.dtype
    assert np.abs(audio[:2]).max() > 0 and not t_audio[2].any()
    if pcm16:
        # the f32 tolerance below (1e-4 of the peak, which pcm16 scales to
        # full scale) in 16-bit steps, plus one step of rounding
        diff = np.abs(t_audio.astype(np.int32) - audio.astype(np.int32))
        assert diff.max() <= int(1e-4 * 32767) + 1, diff.max()
    else:
        scale = np.abs(audio).max()
        np.testing.assert_allclose(t_audio / scale, audio / scale, atol=1e-4)
