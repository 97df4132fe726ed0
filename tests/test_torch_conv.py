# -*- coding: utf-8 -*-
"""PyTorch port: the fused AdaIN-Snake-conv op of the Generator's residual
blocks (``ops/adain_snake_conv.py``) against the JAX package.

On ``tests/test_pallas.py``'s cases (B=2, C=128, a masked tail on row 1),
the port's masked moments, AdaIN fold and plain fused op must agree with
the JAX ``instance_moments``/``fold_adain``/``adain_snake_conv_reference``
and with both Pallas kernels run in interpret mode. f32 on the CPU,
atol = rtol = 1e-4 (the packages and the Pallas tiling sum in other
orders). The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against ``adain_snake_conv_plain``; here the
wrappers take the plain path because their tensors lie on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.ops.pallas.carry_conv import adain_snake_conv_carry
from illufly_tts_tpu.ops.pallas.fused_conv import (
    adain_snake_conv,
    adain_snake_conv_reference,
    fold_adain,
    instance_moments,
)
from illufly_tts_tpu_torch.ops import adain_snake_conv as asc

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
B, C = 2, 128
CASES = [(k, d, length) for k, d in [(3, 1), (7, 3), (11, 5)]
         for length in (384, 130, 1000)]


def _inputs(k, length, seed=0):
    """tests/test_pallas.py's recipe: x [B, L, C], a mask with a masked
    tail on row 1, style gamma/beta, alphas, taps [k, C, C], bias."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, length, C).astype(np.float32) * 0.5
    mask = (np.arange(length)[None, :]
            < np.array([[length], [max(length - 60, 9)]])).astype(np.float32)
    gamma = rng.randn(B, C).astype(np.float32) * 0.1
    beta = rng.randn(B, C).astype(np.float32) * 0.1
    alpha = np.abs(rng.randn(C)).astype(np.float32) + 0.5
    w = rng.randn(k, C, C).astype(np.float32) * 0.05
    bias = rng.randn(C).astype(np.float32) * 0.1
    return x, mask, gamma, beta, alpha, w, bias


def _port(k, d, length):
    """The port's path: moments, fold, plain fused op -> numpy [B, C, L]."""
    x, mask, gamma, beta, alpha, w, bias = map(torch.from_numpy,
                                               _inputs(k, length))
    x_t = x.transpose(1, 2).contiguous()
    scale, shift = asc.fold_adain(*asc.instance_moments(x_t, mask), gamma,
                                  beta)
    return asc.adain_snake_conv_plain(x_t, mask, scale, shift, alpha, w,
                                      bias, k, d).numpy()


def _jax_args(k, length):
    """The JAX path's kernel arguments (x transposed to [B, C, L])."""
    x, mask, gamma, beta, alpha, w, bias = map(jnp.asarray,
                                               _inputs(k, length))
    scale, shift = fold_adain(*instance_moments(x, mask), gamma, beta)
    return (jnp.transpose(x, (0, 2, 1)), mask, scale, shift, alpha, w,
            bias)


def _close(port, ref):
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("length", [384, 130, 1000])
def test_moments_and_fold_match_jax(length):
    x, mask, gamma, beta, *_ = _inputs(3, length)
    mean, rstd = instance_moments(jnp.asarray(x), jnp.asarray(mask))
    scale, shift = fold_adain(mean, rstd, jnp.asarray(gamma),
                              jnp.asarray(beta))
    x_t = torch.from_numpy(x).transpose(1, 2)
    t_mean, t_rstd = asc.instance_moments(x_t, torch.from_numpy(mask))
    t_scale, t_shift = asc.fold_adain(t_mean, t_rstd,
                                      torch.from_numpy(gamma),
                                      torch.from_numpy(beta))
    for port, ref in ((t_mean, mean), (t_rstd, rstd), (t_scale, scale),
                      (t_shift, shift)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=1e-5)
    # the masked tail does not enter row 1's moments
    valid = int(mask[1].sum())
    np.testing.assert_allclose(t_mean[1].numpy(), x[1, :valid].mean(0),
                               atol=1e-6)


@pytest.mark.parametrize("k,d,length", CASES)
def test_plain_matches_jax_reference(k, d, length):
    _close(_port(k, d, length),
           adain_snake_conv_reference(*_jax_args(k, length), k, d))


@pytest.mark.parametrize("k,d,length", CASES)
def test_plain_matches_pallas_halo_tile(k, d, length):
    _close(_port(k, d, length),
           adain_snake_conv(*_jax_args(k, length), k, d, block_len=256,
                            interpret=True))


@pytest.mark.parametrize("k,d,length", CASES)
def test_plain_matches_pallas_carry(k, d, length):
    _close(_port(k, d, length),
           adain_snake_conv_carry(*_jax_args(k, length), k, d,
                                  block_len=256, interpret=True))


def test_wrappers_on_cpu_take_plain_path():
    x, mask, _, _, alpha, w, bias = map(torch.from_numpy, _inputs(7, 130))
    x_t = x.transpose(1, 2).contiguous()
    scale, shift = torch.ones(B, C), torch.zeros(B, C)
    args = (x_t, mask, scale, shift, alpha, w, bias, 7, 3)
    plain = asc.adain_snake_conv_plain(*args)
    before = dict(asc.launches)
    for fn in (asc.adain_snake_conv, asc.adain_snake_conv_carry):
        np.testing.assert_array_equal(fn(*args).numpy(), plain.numpy())
    assert asc.launches == before  # the plain path launches nothing
    bad = {
        "w": (x_t, mask, scale, shift, alpha, w[:, :64], bias, 7, 3),
        "mask": (x_t, mask[:, :64], scale, shift, alpha, w, bias, 7, 3),
        "odd": (x_t, mask, scale, shift, alpha, w[:6], bias, 6, 3),
        # a tensor on no CPU and no CUDA device: no kernel, no plain path
        "CUDA": (x_t.to("meta"), mask, scale, shift, alpha, w, bias, 7, 3),
    }
    for match, bad_args in bad.items():
        with pytest.raises(ValueError, match=match):
            asc.adain_snake_conv_carry(*bad_args)


@pytest.mark.parametrize("batch,c_out,length", [
    (8, 128, 61440),   # b8 stage 1 (F 512)
    (8, 256, 10240),   # b8 stage 0
    (1, 128, 11520),   # one stream window (64 + 2 * 16 frames), stage 1
    (1, 256, 1920),    # one stream window, stage 0
    (1, 128, 37),      # shorter than one tile
])
def test_carry_chunks_cover_the_card(batch, c_out, length):
    """Chunks tile each row exactly; the grid reaches the 132 SMs of an
    H100 wherever the row has the tiles for it, and chunks stay long
    where it has more."""
    sms = 132
    per_chunk = asc.carry_tiles_per_chunk(batch, c_out, length, sms)
    n_tiles = -(-length // asc.TILE_LEN)
    chunks = -(-n_tiles // per_chunk)
    assert 1 <= per_chunk <= n_tiles
    assert (chunks - 1) * per_chunk < n_tiles <= chunks * per_chunk
    ctas = chunks * batch * -(-c_out // asc.COUT_TILE)
    most = n_tiles * batch * -(-c_out // asc.COUT_TILE)
    assert ctas >= min(asc.CARRY_CTAS_PER_SM * sms, most)
    assert ctas <= 2 * asc.CARRY_CTAS_PER_SM * sms or per_chunk == 1
