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


@pytest.mark.parametrize("k,d,length", CASES)
def test_3xtf32_emulation_matches_jax_reference(k, d, length):
    """The kernels' split arithmetic (emulated on the CPU) against the JAX
    reference, at the plain version's tolerance."""
    x, mask, gamma, beta, alpha, w, bias = map(torch.from_numpy,
                                               _inputs(k, length))
    x_t = x.transpose(1, 2).contiguous()
    scale, shift = asc.fold_adain(*asc.instance_moments(x_t, mask), gamma,
                                  beta)
    _close(asc.adain_snake_conv_3xtf32_plain(x_t, mask, scale, shift, alpha,
                                             w, bias, k, d).numpy(),
           adain_snake_conv_reference(*_jax_args(k, length), k, d))


def test_tf32_round_is_cvt_rna():
    """Round to nearest on 10 mantissa bits, ties away from zero, sign
    kept; TF32 values, zeros and powers of two pass unchanged."""
    ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 3 * ulp / 2, 0.0, -0.0,
                      2.0 ** -30, 3.0 + ulp / 4])
    want = [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 0.0, -0.0,
            2.0 ** -30, 3.0]
    out = asc.tf32_round(v)
    assert out.tolist() == want
    assert torch.signbit(out[6])
    rng = np.random.RandomState(3)
    r = torch.from_numpy(rng.randn(4096).astype(np.float32) * 100)
    hi = asc.tf32_round(r)
    assert torch.equal(asc.tf32_round(hi), hi)  # idempotent
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11


def test_3xtf32_split_holds_the_f32_tolerance_and_tf32_does_not():
    """Why the kernels split: at C=256, k=11, d=5 (2816 terms a sum), 3xTF32
    stays within chip_smoke's CONV_TOL of the f32 version, 1e-4 * (1 +
    max|plain|), and a single TF32 pass does not."""
    rng = np.random.RandomState(0)
    batch, c, length, k, d = 2, 256, 1000, 11, 5

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    args = (t(rng.randn(batch, c, length) * 0.5),
            t((np.arange(length)[None] < np.array([[length], [700]]))
              .astype(np.float32)),
            t(1 + 0.1 * rng.randn(batch, c)), t(0.1 * rng.randn(batch, c)),
            t(np.abs(rng.randn(c)) + 0.5),
            t(rng.randn(k, c, c) / np.sqrt(c * k)), t(0.1 * rng.randn(c)))
    plain = asc.adain_snake_conv_plain(*args, k, d)
    tol = 1e-4 * (1.0 + float(plain.abs().max()))
    split = asc.adain_snake_conv_3xtf32_plain(*args, k, d)
    single = asc.adain_snake_conv_3xtf32_plain(*args, k, d, passes=1)
    assert float((split - plain).abs().max()) <= tol / 10
    assert float((single - plain).abs().max()) > tol
    with pytest.raises(ValueError, match="passes"):
        asc.adain_snake_conv_3xtf32_plain(*args, k, d, passes=2)


SHAPES = [
    (8, 128, 61440),   # b8 stage 1 (F 512)
    (8, 256, 10240),   # b8 stage 0
    (1, 128, 11520),   # one stream window (64 + 2 * 16 frames), stage 1
    (1, 256, 1920),    # one stream window, stage 0
    (1, 128, 37),      # shorter than one tile
]


def _busiest_sm(batch, c_out, length, sms, tile_len):
    ctas = batch * -(-c_out // asc.COUT_TILE) * -(-length // tile_len)
    return -(-ctas // sms) * asc.TILE_COST[tile_len]


@pytest.mark.parametrize("batch,c_out,length", SHAPES)
def test_column_tile_finishes_the_busiest_sm_first(batch, c_out, length):
    """The chosen tile minimises the busiest SM's work on an H100's 132
    SMs, and among equal choices is the longest."""
    sms = 132
    tile_len = asc.column_tile(batch, c_out, length, sms)
    assert tile_len in asc.TILE_LENS
    best = min(_busiest_sm(batch, c_out, length, sms, tl)
               for tl in asc.TILE_LENS)
    assert _busiest_sm(batch, c_out, length, sms, tile_len) == best
    assert all(tl <= tile_len for tl in asc.TILE_LENS
               if _busiest_sm(batch, c_out, length, sms, tl) == best)


def test_column_tile_by_shape():
    """Large shapes take the 128-column tile; a B=1 stage-0 stream window
    (15 tiles of 128, two output-channel tiles) spreads over 60 CTAs of 64
    columns."""
    assert asc.column_tile(8, 128, 61440, 132) == 128
    assert asc.column_tile(8, 256, 10240, 132) == 128
    assert asc.column_tile(1, 128, 11520, 132) == 128
    assert asc.column_tile(1, 256, 1920, 132) == 64


@pytest.mark.parametrize("kernel,dilation", [(3, 5), (7, 3), (11, 1),
                                             (11, 5)])
@pytest.mark.parametrize("batch,c_out,length", SHAPES)
def test_carry_chunks_cover_the_card(batch, c_out, length, kernel, dilation):
    """Chunks of the chosen tile tile each row exactly. Where the carry
    buffer fits beside the stage buffers, about one wave of CTAs walks (no
    more CTAs than the 132 SMs of an H100, at least half of them where the
    rows have the tiles); where it does not, one tile a chunk."""
    sms = 132
    tile_len = asc.column_tile(batch, c_out, length, sms)
    per_chunk = asc.carry_tiles_per_chunk(batch, c_out, c_out, length,
                                          kernel, dilation, sms, tile_len)
    n_tiles = -(-length // tile_len)
    chunks = -(-n_tiles // per_chunk)
    assert 1 <= per_chunk <= n_tiles
    assert (chunks - 1) * per_chunk < n_tiles <= chunks * per_chunk
    rows = batch * -(-c_out // asc.COUT_TILE)
    carry = 2 * c_out * (kernel - 1) * dilation
    if asc.smem_bytes(tile_len, kernel, carry) > asc.MAX_SMEM:
        assert per_chunk == 1
    else:
        assert chunks * rows <= sms
        assert chunks * rows >= min(sms, n_tiles * rows) / 2


@pytest.mark.parametrize("batch,c_out,length", SHAPES)
def test_tile_runs_cover_the_card(batch, c_out, length):
    """The halo-tile kernel's runs of consecutive tiles cover each row
    exactly, in about one wave: no more CTAs than the 132 SMs of an H100,
    at least half of them where the rows have the tiles."""
    sms = 132
    tile_len = asc.column_tile(batch, c_out, length, sms)
    per_cta = asc.tiles_per_cta(batch, c_out, length, sms, tile_len)
    n_tiles = -(-length // tile_len)
    runs = -(-n_tiles // per_cta)
    rows = batch * -(-c_out // asc.COUT_TILE)
    assert 1 <= per_cta <= n_tiles
    assert (runs - 1) * per_cta < n_tiles <= runs * per_cta
    assert runs * rows <= max(sms, rows)
    assert runs * rows >= min(sms, n_tiles * rows) / 2


def test_carry_walks_where_its_buffer_fits():
    """At b8's stage 1 (C=128) the carry walks at k <= 7 and at k=11, d=1;
    at k=11, d >= 3 its buffer does not fit, and chunks are one tile."""
    def chunk(kernel, dilation):
        return asc.carry_tiles_per_chunk(8, 128, 128, 61440, kernel,
                                         dilation, 132, 128)

    assert [chunk(k, d) for k, d in [(3, 5), (7, 3), (7, 5), (11, 1)]] == [
        30] * 4
    assert chunk(11, 3) == chunk(11, 5) == 1
    assert asc.smem_bytes(128, 11, 0) <= asc.MAX_SMEM
