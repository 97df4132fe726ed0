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


# ---- the bf16 forms' held weights and geometry ------------------------------

PACK_CASES = [(11, 128, 128), (7, 24, 256), (3, 256, 256), (3, 24, 40)]


@pytest.mark.parametrize("kernel,c_in,c_out", PACK_CASES)
def test_pack_weights_round_trips_bit_for_bit(kernel, c_in, c_out):
    """``unpack_weights(pack_weights(w))`` gives back w in bfloat16 bit
    for bit, C_in and C_out not multiples of the 16-channel stage or the
    128-channel tile included."""
    w = torch.from_numpy(np.random.RandomState(kernel).randn(
        kernel, c_in, c_out).astype(np.float32)).bfloat16()
    packed = asc.pack_weights(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == asc.packed_shape(kernel, c_in, c_out)
    back = asc.unpack_weights(packed, c_in, c_out)
    assert torch.equal(back.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("kernel,c_in,c_out", PACK_CASES)
def test_packed_weights_at_the_kernels_addresses(kernel, c_in, c_out):
    """A pure-Python model of the bytes the bf16 kernels read: the copy
    engine brings stage ``st`` of output tile ``o_tile`` from byte
    ``(o_tile * stages + st) * k * W_TAP_BYTES`` (``start_weights_bf16``),
    and the MMAs read tap t's row (output channel) r of k half ``half``
    at ``t * W_TAP_BYTES + half * 128 * 16 + r * 16`` of the stage, eight
    input channels of 2 bytes (the K-major descriptor: 16-byte rows, the
    halves 128 rows apart). Each such byte pair holds w's value, zero past
    C_in and C_out."""
    rng = np.random.RandomState(c_out)
    w = rng.randn(kernel, c_in, c_out).astype(np.float32)
    raw = asc.pack_weights(torch.from_numpy(w)).view(torch.int16).numpy()
    raw = raw.reshape(-1)
    want = torch.from_numpy(w).bfloat16().view(torch.int16).numpy()
    tiles, stages = -(-c_out // asc.COUT_TILE), -(-c_in // asc.CIN_STAGE)
    assert raw.size * 2 == tiles * stages * kernel * asc.W_TAP_BYTES
    seen = 0
    for o_tile in range(tiles):
        for st in range(stages):
            stage_byte = (o_tile * stages + st) * kernel * asc.W_TAP_BYTES
            for t in range(kernel):
                for half in range(2):
                    rows = np.arange(asc.COUT_TILE)[:, None]
                    j = np.arange(8)[None, :]
                    byte = (stage_byte + t * asc.W_TAP_BYTES
                            + half * asc.COUT_TILE * 16 + rows * 16 + 2 * j)
                    got = raw[byte // 2]
                    ci = st * asc.CIN_STAGE + 8 * half + j
                    co = o_tile * asc.COUT_TILE + rows
                    inside = (ci < c_in) & (co < c_out)
                    expect = np.where(inside, want[t, np.minimum(ci, c_in - 1),
                                                   np.minimum(co, c_out - 1)],
                                      0)
                    np.testing.assert_array_equal(got, expect)
                    seen += got.size
    assert seen == raw.size


def test_bf16_plain_takes_packed_weights():
    """The plain version gives the same bits for w as it comes and packed:
    the CPU path of a model that holds packed weights."""
    x, mask, gamma, beta, alpha, w, b = _inputs(7, 130)
    xt = torch.from_numpy(x).permute(0, 2, 1).contiguous().bfloat16()
    w = torch.from_numpy(w)
    scale = 1.0 + torch.from_numpy(gamma)
    args = (xt, torch.from_numpy(mask), scale, torch.from_numpy(beta),
            torch.from_numpy(alpha).reshape(-1))
    bias = torch.from_numpy(b).reshape(-1)
    want = asc.adain_snake_conv_plain(*args, w, bias, 7, 3)
    got = asc.adain_snake_conv_plain(*args, asc.pack_weights(w), bias, 7, 3)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


BF16_MAIN_TILES = {
    (32, 128, 61440): 256,  # bench.py's shape (B=32, F 512), stage 1
    (8, 128, 61440): 256,   # the timed shape, stage 1
    (32, 256, 10240): 256,  # bench.py's stage 0
    (8, 256, 10240): 256,   # B=8 stage 0
    (1, 128, 11520): 128,   # a B=1 stream window (64 + 2 * 16 frames)
    (1, 256, 1920): 64,     # its stage 0
}


@pytest.mark.parametrize("shape", sorted(BF16_MAIN_TILES))
def test_bf16_column_tile_by_shape(shape):
    """The bf16 forms take 256-column tiles at the batch path's shapes
    (each stage's weights feed 256 columns) and shorter ones at the B=1
    stream windows, which spread over more SMs; each choice finishes the
    busiest of 132 SMs first by ``TILE_COST_BF16``, the longest among
    equals."""
    batch, c_out, length = shape
    tile_len = asc.column_tile(batch, c_out, length, 132, bf16=True)
    assert tile_len == BF16_MAIN_TILES[shape]

    def busiest(tl):
        ctas = batch * -(-c_out // asc.COUT_TILE) * -(-length // tl)
        return -(-ctas // 132) * asc.TILE_COST_BF16[tl]

    best = min(busiest(tl) for tl in asc.TILE_LENS_BF16)
    assert busiest(tile_len) == best
    assert all(tl <= tile_len for tl in asc.TILE_LENS_BF16
               if busiest(tl) == best)


BF16_KD = [(k, d) for k in (3, 7, 11) for d in (1, 2, 3, 4, 5)
           if (k - 1) * d % 2 == 0]


@pytest.mark.parametrize("tile_len", [256, 128, 64])
def test_bf16_shared_memory_fits_with_the_carry(tile_len):
    """Every bf16 launch of k <= 11, d <= 5 fits the 232448 bytes a CTA
    may take, with the walking carry of C_in = 256 (the widest Generator
    stage) beside its stages; the formula is the source's (checked at
    load on the card)."""
    for k, d in BF16_KD:
        carry = (256 + 1) // 2 * (k - 1) * d
        assert asc.smem_bytes(tile_len, k, 0, bf16=True) <= asc.MAX_SMEM
        assert asc.smem_bytes(tile_len, k, carry, bf16=True) <= asc.MAX_SMEM
    # at the largest launch: 3 stages of 45 KB weights and a 324-row
    # window, 3 raw buffers (x rows of 344, a 328-column mask, 48
    # parameters), 128 bytes of mbarriers
    assert asc.smem_bytes(256, 11, 0, bf16=True) == 4 * (
        32 + 3 * (11 * 1024 + 8 * 324) + 3 * (16 * 172 + 328 + 48))


@pytest.mark.parametrize("kernel,dilation", [(3, 5), (7, 3), (11, 1),
                                             (11, 5)])
@pytest.mark.parametrize("shape", sorted(BF16_MAIN_TILES))
def test_bf16_carry_walks_and_covers_the_card(shape, kernel, dilation):
    """The bf16 carry walks at every main-path shape (its buffer fits):
    chunks of the chosen tile cover each row exactly, in about one wave;
    the halo-tile runs likewise."""
    batch, c_out, length = shape
    sms = 132
    tile_len = asc.column_tile(batch, c_out, length, sms, bf16=True)
    per_chunk = asc.carry_tiles_per_chunk(batch, c_out, c_out, length,
                                          kernel, dilation, sms, tile_len,
                                          bf16=True)
    per_cta = asc.tiles_per_cta(batch, c_out, length, sms, tile_len)
    n_tiles = -(-length // tile_len)
    rows = batch * -(-c_out // asc.COUT_TILE)
    assert per_chunk == per_cta  # walking, not one-tile chunks
    runs = -(-n_tiles // per_chunk)
    assert (runs - 1) * per_chunk < n_tiles <= runs * per_chunk
    assert runs * rows <= max(sms, rows)
    assert runs * rows >= min(sms, n_tiles * rows) / 2
