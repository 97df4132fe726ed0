# -*- coding: utf-8 -*-
"""PyTorch port: voice adaptation against the JAX package on the CPU.

``small_config`` with the JAX random init; batches rendered by the JAX
model under a hidden target style (``rendered_batches``), fed to both
``adapt_voice``s (waveform L1, the clip at 1.0 and Adam at 5e-2), each
warm-started from one random voice (``init``, as ``train-voice
--init-voice`` does). From a zero style the random-init model is
degenerate: its style gradient is ~1e8 and the two frameworks' step-0
losses differ by 1.5%; at a voice-like style they agree to 5e-5. The model
stays frozen: the style vector is the only tensor with a gradient, so it
gets one only through the layers and the kernels' Functions. The returned
style agrees within 1e-3 of the learning rate per entry and the best
step's metrics within 1e-3 relative (the styles it was evaluated at
differ by up to 2.2e-4 of lr on the CPU); the port's own ``rendered_batches`` renders what
JAX renders; the non-finite-step skip keeps the best style."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.training import voice_adapt as jax_va
from illufly_tts_tpu_torch.training import voice_adapt as port_va
from tests.test_parity_torch import small_config
from tests.test_torch_training import JaxModel, init_params, port_model

torch.set_num_threads(2)

B, TOKENS, FRAMES, STEPS, LR = 2, 12, 48, 3, 5e-2


@pytest.fixture(scope="module")
def setup():
    jcfg = small_config()
    params = init_params(jcfg)
    target = (np.random.RandomState(7).randn(2 * jcfg.style_dim) * 0.3
              ).astype(np.float32)
    gen = jax_va.rendered_batches(JaxModel(jcfg), params,
                                  jnp.asarray(target), B, TOKENS, FRAMES,
                                  seed=1)
    batches = [tuple(np.asarray(t) for t in next(gen)) for _ in range(STEPS)]
    init = (np.random.RandomState(9).randn(2 * jcfg.style_dim) * 0.1
            ).astype(np.float32)
    return jcfg, params, init, target, batches


def _jax_batches(batches):
    from illufly_tts_tpu.training.step import TrainBatch

    return iter([TrainBatch(*map(jnp.asarray, b)) for b in batches])


def _port_batches(batches):
    from illufly_tts_tpu_torch.training.step import TrainBatch

    return iter([TrainBatch(torch.tensor(b[0]).long(),
                            *map(torch.tensor, b[1:])) for b in batches])


def test_adapt_voice_matches_jax(setup):
    jcfg, params, init, _, batches = setup
    style, metrics = jax_va.adapt_voice(
        JaxModel(jcfg), params, _jax_batches(batches), steps=STEPS,
        learning_rate=LR, frames=FRAMES, init=init, spectral=False,
        log_every=0)
    model = port_model(jcfg, params)
    ours, our_metrics = port_va.adapt_voice(
        model, _port_batches(batches), steps=STEPS, learning_rate=LR,
        frames=FRAMES, init=init, spectral=False, log_every=0)
    assert ours.shape == style.shape == (2 * jcfg.style_dim,)
    np.testing.assert_allclose(ours, style, rtol=0, atol=1e-3 * LR)
    assert our_metrics.keys() == metrics.keys()
    for key, value in metrics.items():
        assert abs(our_metrics[key] - value) <= 1e-3 * abs(value), key
    assert np.abs(ours - init).max() > 0.5 * LR  # the style moved
    assert not any(p.requires_grad for p in model.parameters())


def test_rendered_batches_match_jax(setup):
    jcfg, params, _, target, batches = setup
    gen = port_va.rendered_batches(port_model(jcfg, params), target, B,
                                   TOKENS, FRAMES, seed=1)
    for want in batches[:2]:
        got = next(gen)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a.numpy(), b)
        scale = np.abs(want[4]).max()
        np.testing.assert_allclose(got[4].numpy() / scale, want[4] / scale,
                                   atol=1e-4)


def test_non_finite_step_is_skipped(setup, monkeypatch):
    """A NaN loss updates nothing; the style returned is the best finite
    one, the style that loss was evaluated at."""
    jcfg, params, init, _, batches = setup
    model = port_model(jcfg, params)
    bad = list(_port_batches(batches[:2]))
    bad[1] = bad[1]._replace(target_audio=bad[1].target_audio * np.nan)
    style, metrics = port_va.adapt_voice(
        model, iter(bad * 2), steps=4, learning_rate=LR, frames=FRAMES,
        init=init, spectral=False, log_every=0)
    assert np.isfinite(style).all() and np.isfinite(metrics["best_loss"])
    np.testing.assert_array_equal(port_va.style_to_pack(style)[3, 0], style)
