# -*- coding: utf-8 -*-
"""PyTorch port: step 0 of the spectral objective (duration MSE + mel-L1 +
multi-resolution STFT, ``audio/mel_torch.py``) against the JAX package on
the CPU: ``small_config``, the JAX random init, a random target waveform;
the loss and each metric within 1e-4 relative, every leaf's gradient
within 1e-3 relative L2 (``tests/test_torch_training.py`` has the
tolerances and the degenerate leaves)."""
import numpy as np
import pytest
import torch

from illufly_tts_tpu.audio import mel_jax
from illufly_tts_tpu_torch.audio import mel_torch
from tests.test_parity_torch import small_config
from tests.test_torch_training import _batch, assert_step0_matches, init_params

torch.set_num_threads(2)


def test_step0_spectral_loss_and_grads_match_jax():
    jcfg = small_config()
    assert_step0_matches(jcfg, init_params(jcfg), _batch(jcfg, seed=1),
                         spectral=True)


@pytest.mark.parametrize("fn", ["log_mel", "mel_l1", "multi_res_stft_loss"])
def test_mel_losses_match_jax(fn):
    rng = np.random.RandomState(4)
    a = (rng.randn(2, 6000) * 0.3).astype(np.float32)
    b = (rng.randn(2, 6000) * 0.3).astype(np.float32)
    args = (a,) if fn == "log_mel" else (a, b)
    want = np.asarray(getattr(mel_jax, fn)(*args))
    got = getattr(mel_torch, fn)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
