# -*- coding: utf-8 -*-
"""PyTorch port: the AdaIN statistics pass (``ops/adain_moments.py``)
against the JAX package's ``instance_moments`` + ``fold_adain``
(``illufly_tts_tpu/ops/pallas/fused_conv.py``), its moments-only form
(gamma and beta None) against ``instance_moments``, and the layers that
take their moments or scale/shift from it against their flax twins.

Inputs come from numpy seeds; x goes to JAX transposed to its ``[B, T,
C]``. Everything runs on the CPU, where ``adain_fold`` takes its plain
version; the CUDA kernel is held to ``adain_fold_plain`` on the card by
``chip_smoke.py``. ``adain_fold_chunked_plain`` computes the kernel's
chunked arithmetic (per-chunk count, mean and centered M2, combined left to
right by Chan's formula).

Tolerances, each with its reason:

- scale and shift, float32: ``|port - JAX| <= 1e-5 * max |JAX|`` plus
  ``rtol`` 1e-5 (both sum in float32, in other orders; shift is ``beta -
  mean * scale``, which cancels, so the bound is taken at the output's
  peak, as ``chip_smoke.py`` holds the kernel). A bfloat16 x is compared
  with JAX on the same values widened, at the same tolerance: the pass
  computes in float32.
- gradients against ``jax.grad``: ``tests/test_torch_layers.py``'s atol
  1e-5 / rtol 1e-4, scaled by the gradient's peak.
- the layers: ``tests/test_torch_layers.py``'s float32 tolerance and
  ``tests/test_torch_bf16.py``'s bfloat16 ratio, unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.model import layers as jl
from illufly_tts_tpu.ops.pallas.fused_conv import fold_adain, instance_moments
from illufly_tts_tpu_torch.engine import graphs
from illufly_tts_tpu_torch.model import layers as tl
from illufly_tts_tpu_torch.ops import adain_moments as am
from illufly_tts_tpu_torch.ops.capture_tally import captured
from illufly_tts_tpu_torch.ops.kernel_grad import kernel_call
from tests.test_model import tiny_config
from tests.test_torch_bf16 import _bf16_values, _check_ratio, _layer_case, _t
from tests.test_torch_layers import _cf, _cl, _close, _mask, _shared_params

torch.set_num_threads(2)

TOL = 1e-5       # of max |JAX|, and rtol: scale and shift
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# tiny_config's widths: the decoder's style, the Generator's first stage
STYLE = tiny_config().style_dim
GEN_CHANNELS = tiny_config().istftnet.upsample_initial_channel // 2
B = 3


def _lengths(length, kind):
    """Per-row valid lengths for a mask kind: ragged (full, cut, all-zero),
    or None for no mask."""
    if kind == "none":
        return None
    return np.array([length, max(1, length - 2 * length // 5), 0])


def _inputs(channels, length, kind, seed=0, fractional=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, channels, length) * 1.5 + 0.7).astype(np.float32)
    lengths = _lengths(length, kind)
    mask = None
    if lengths is not None:
        mask = (np.arange(length)[None, :] < lengths[:, None]).astype(
            np.float32)
        if fractional:  # weights: one row's total below 1 (count clamped)
            mask[0] *= 0.5
            mask[2, :3] = 0.25
    gamma = (rng.randn(B, channels) * 0.3).astype(np.float32)
    beta = (rng.randn(B, channels) * 0.3).astype(np.float32)
    return x, mask, gamma, beta


def _jax_fold(x, mask, gamma, beta):
    x_t = jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1)))
    mean, rstd = instance_moments(x_t, None if mask is None
                                  else jnp.asarray(mask))
    scale, shift = fold_adain(mean, rstd, jnp.asarray(gamma),
                              jnp.asarray(beta))
    return np.asarray(scale), np.asarray(shift)


def _jax_moments(x, mask):
    x_t = jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1)))
    return tuple(map(np.asarray, instance_moments(
        x_t, None if mask is None else jnp.asarray(mask))))


def _held(port, ref):
    for got, want in zip(port, ref):
        got = got.detach().numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()))


def _tensors(x, mask, gamma, beta, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(gamma), torch.from_numpy(beta))


FOLDS = {
    "plain": am.adain_fold_plain,
    "chunked": am.adain_fold_chunked_plain,
    "chunked_64": lambda *a: am.adain_fold_chunked_plain(*a, chunk=64),
    "wrapper": am.adain_fold,
}
# (channels, length): one chunk; the kernel's chunk and a ragged second
# chunk in which the cut row's mask ends; a short chunk (64) across many
SHAPES = [(5, 37), (4, am.CHUNK + 300), (6, 300)]


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("kind", ["ragged", "none"])
@pytest.mark.parametrize("channels,length", SHAPES)
def test_fold_matches_jax(fold, kind, channels, length):
    x, mask, gamma, beta = _inputs(channels, length, kind)
    _held(FOLDS[fold](*_tensors(x, mask, gamma, beta)),
          _jax_fold(x, mask, gamma, beta))


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("channels,length", SHAPES)
def test_fold_bf16_x_matches_jax_on_widened_x(fold, channels, length):
    x, mask, gamma, beta = _inputs(channels, length, "ragged", seed=1)
    x = _bf16_values(x)
    port = FOLDS[fold](*_tensors(x, mask, gamma, beta, torch.bfloat16))
    _held(port, _jax_fold(x, mask, gamma, beta))


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("kind", ["ragged", "none"])
@pytest.mark.parametrize("channels,length", SHAPES)
def test_moments_match_jax(fold, kind, channels, length):
    """gamma and beta None: (mean, rstd), the JAX ``instance_moments``."""
    x, mask, _, _ = _inputs(channels, length, kind, seed=3)
    _held(FOLDS[fold](torch.from_numpy(x), None if mask is None
                      else torch.from_numpy(mask), None, None),
          _jax_moments(x, mask))


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_moments_bf16_x_match_jax_on_widened_x(fold):
    x, mask, _, _ = _inputs(6, 300, "ragged", seed=4)
    x = _bf16_values(x)
    x16 = torch.from_numpy(x).bfloat16()
    _held(FOLDS[fold](x16, torch.from_numpy(mask), None, None),
          _jax_moments(x, mask))


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_fold_fractional_weights_match_jax(fold):
    """Weights below 1 take the count clamp inside a row (the kernel's
    ``n < 1`` branch): the mean is sum x m, the variance about it."""
    x, mask, gamma, beta = _inputs(4, 300, "ragged", seed=2,
                                   fractional=True)
    _held(FOLDS[fold](*_tensors(x, mask, gamma, beta)),
          _jax_fold(x, mask, gamma, beta))


def test_all_zero_mask_row_is_the_style_affine():
    """count = max(0, 1): mean 0, var 0, so scale = (1 + gamma) /
    sqrt(eps) and shift = beta, exactly, in both forms."""
    x, mask, gamma, beta = _inputs(4, am.CHUNK + 10, "ragged")
    for fold in (am.adain_fold_plain, am.adain_fold_chunked_plain):
        scale, shift = fold(*_tensors(x, mask, gamma, beta))
        torch.testing.assert_close(shift[2], torch.from_numpy(beta[2]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            scale[2], (1.0 + torch.from_numpy(gamma[2]))
            * torch.rsqrt(torch.tensor(am.EPS)), rtol=0, atol=0)
        mean, rstd = fold(*_tensors(x, mask, gamma, beta)[:2], None, None)
        assert not mean[2].any()
        assert torch.equal(rstd[2], torch.rsqrt(torch.tensor(am.EPS))
                           .expand(4))


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    x, mask, gamma, beta = _tensors(*_inputs(5, 200, "ragged"))
    before = dict(am.launches), dict(am.launches_bf16)
    got = am.adain_fold(x, mask, gamma, beta)
    got16 = am.adain_fold(x.bfloat16(), mask, gamma, beta)
    moments = am.adain_fold(x, mask, None, None)
    assert (dict(am.launches), dict(am.launches_bf16)) == before
    torch.testing.assert_close(got, am.adain_fold_plain(x, mask, gamma,
                                                        beta), rtol=0, atol=0)
    torch.testing.assert_close(got16, am.adain_fold_plain(
        x.bfloat16().float(), mask, gamma, beta), rtol=0, atol=0)
    torch.testing.assert_close(moments, am.adain_fold_plain(
        x, mask, None, None), rtol=0, atol=0)


def test_wrapper_takes_strided_style_rows():
    """gamma and beta as the halves of one fc output [B, 2C] (rows at
    stride 2C), as the layers hand them over."""
    x, mask, gamma, beta = _tensors(*_inputs(5, 64, "ragged"))
    gamma_s, beta_s = torch.cat([gamma, beta], dim=1).chunk(2, dim=1)
    assert gamma_s.stride() == (10, 1)
    torch.testing.assert_close(am.adain_fold(x, mask, gamma_s, beta_s),
                               am.adain_fold(x, mask, gamma, beta),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["x", "mask", "gamma", "beta_only",
                                 "device"])
def test_wrapper_rejects(bad):
    x, mask, gamma, beta = _tensors(*_inputs(5, 64, "ragged"))
    if bad == "x":
        x = x[0]
    elif bad == "mask":
        mask = mask[:, 1:]
    elif bad == "gamma":
        gamma = gamma[:, 1:]
    elif bad == "beta_only":  # the moments form takes neither
        gamma = None
    else:  # neither all on the CPU nor all on one CUDA device
        x = x.to("meta")
    with pytest.raises(ValueError):
        am.adain_fold(x, mask, gamma, beta)


def test_launch_counts_reach_tables_and_capture_tallies(monkeypatch):
    monkeypatch.setattr(am, "launches", {"adain_fold": 0})
    monkeypatch.setattr(am, "launches_bf16", {"adain_fold_bf16": 0})
    with captured() as tally:
        am.count_launch("adain_fold", 3)
    assert tally == {"adain_fold": 3} and am.launches["adain_fold"] == 0
    graphs.add_launches({"adain_fold": 2, "adain_fold_bf16": 1}, times=3)
    assert am.launches == {"adain_fold": 6}
    assert am.launches_bf16 == {"adain_fold_bf16": 3}


def _grads(fold, x, mask, gamma, beta, seed=3):
    """d/d(x, gamma, beta) of a seeded weighting of (scale, shift)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(2, *gamma.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    scale, shift = fold(leaves[0], mask, leaves[1], leaves[2])
    ((scale * w[0]).sum() + (shift * w[1]).sum()).backward()
    return [t.grad for t in leaves], w.numpy()


@pytest.mark.parametrize("kind", ["ragged", "none"])
def test_gradient_through_kernel_call_is_the_plain_forms(kind):
    """The kernel's autograd route (``kernel_call``), with the chunked
    emulation standing in for the launch: its gradients are those of
    ``adain_fold_plain`` differentiated directly, bit for bit, and those
    match ``jax.grad`` of the JAX fold."""
    x, mask, gamma, beta = _tensors(*_inputs(4, 300, kind))

    def through_kernel_call(x, mask, gamma, beta):
        def launch(x, gamma, beta):
            with torch.no_grad():
                return torch.stack(am.adain_fold_chunked_plain(
                    x, mask, gamma, beta, chunk=64))

        def plain(x, gamma, beta):
            return torch.stack(am.adain_fold_plain(x, mask, gamma, beta))

        return kernel_call(launch, plain, x, gamma, beta).unbind(0)

    got, w = _grads(through_kernel_call, x, mask, gamma, beta)
    want, _ = _grads(am.adain_fold_plain, x, mask, gamma, beta)
    via_wrapper, _ = _grads(am.adain_fold, x, mask, gamma, beta)
    for g, p, v in zip(got, want, via_wrapper):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
        torch.testing.assert_close(v, p, rtol=0, atol=0)

    def loss(x_t, gamma, beta):
        m = None if mask is None else jnp.asarray(mask.numpy())
        scale, shift = fold_adain(*instance_moments(x_t, m), gamma, beta)
        return (scale * w[0]).sum() + (shift * w[1]).sum()

    x_t = jnp.asarray(x.numpy().transpose(0, 2, 1))
    ref = jax.grad(loss, argnums=(0, 1, 2))(x_t, jnp.asarray(gamma.numpy()),
                                            jnp.asarray(beta.numpy()))
    ref = [np.asarray(ref[0]).transpose(0, 2, 1), *map(np.asarray, ref[1:])]
    for g, r in zip(want, ref):
        np.testing.assert_allclose(
            g.numpy(), r, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(r).max()))


@pytest.mark.parametrize("kind", ["ragged", "none"])
def test_moments_gradient_is_the_plain_forms(kind):
    """The moments form's gradient of x: through the wrapper that of
    ``instance_moments`` differentiated directly, bit for bit, and that
    matches ``jax.grad`` of the JAX moments."""
    x, mask, _, _ = _tensors(*_inputs(4, 300, kind, seed=5))
    w = np.random.RandomState(6).randn(2, B, 4).astype(np.float32)

    def grad(fn):
        leaf = x.clone().requires_grad_(True)
        mean, rstd = fn(leaf, mask, None, None)
        ((mean * torch.from_numpy(w[0])).sum()
         + (rstd * torch.from_numpy(w[1])).sum()).backward()
        return leaf.grad

    want = grad(am.adain_fold_plain)
    torch.testing.assert_close(grad(am.adain_fold), want, rtol=0, atol=0)

    def loss(x_t):
        m = None if mask is None else jnp.asarray(mask.numpy())
        mean, rstd = instance_moments(x_t, m)
        return (mean * w[0]).sum() + (rstd * w[1]).sum()

    ref = np.asarray(jax.grad(loss)(jnp.asarray(
        x.numpy().transpose(0, 2, 1)))).transpose(0, 2, 1)
    np.testing.assert_allclose(want.numpy(), ref, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * float(np.abs(ref).max()))


# ---- the layers, at tiny_config's widths ----------------------------------


@pytest.mark.parametrize("masked", [True, False])
def test_adain1d_tiny_width(masked):
    """``AdaIN1d`` normalizes with the pass's moments as JAX does,
    ``(x - mean) * rstd * (1 + gamma) + beta``."""
    rng = np.random.RandomState(4)
    channels, steps = 2 * tiny_config().hidden_dim, 40
    x = (rng.randn(B, steps, channels) * 2 + 1).astype(np.float32)
    s = rng.randn(B, STYLE).astype(np.float32)
    mask = _mask(steps) if masked else None
    fl, pt = jl.AdaIN1d(channels), tl.AdaIN1d(STYLE, channels)
    args = [jnp.asarray(x), jnp.asarray(s),
            None if mask is None else jnp.asarray(mask)]
    v = _shared_params(fl, pt, *args)
    out = pt(_cf(x), torch.from_numpy(s),
             None if mask is None else torch.from_numpy(mask))
    _close(_cl(out), fl.apply(v, *args))


@pytest.mark.parametrize("masked", [True, False])
def test_adain1d_tiny_width_bf16(masked):
    rng = np.random.RandomState(5)
    channels, steps = 2 * tiny_config().hidden_dim, 40
    x = _bf16_values(rng.randn(B, steps, channels).astype(np.float32) * 2
                     + 1)
    s = _bf16_values(rng.randn(B, STYLE).astype(np.float32))
    mask = _mask(steps) if masked else None
    out, r16, r32 = _layer_case(
        lambda dt: jl.AdaIN1d(channels, dtype=dt),
        tl.AdaIN1d(STYLE, channels), [x, s, mask],
        [_t(np.ascontiguousarray(x.transpose(0, 2, 1))), _t(s),
         _t(mask, torch.float32)])
    _check_ratio(out, r16, r32, _cl)


def test_adain1d_takes_a_transposed_input(monkeypatch):
    """The F0/N towers hand ``AdaIN1d`` a transposed LSTM output. On the CPU
    the plain moments sum it as it lies, as the eager layer did (the kernel
    on a card gets a contiguous copy); the output matches a contiguous
    input's to float32 rounding."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, 30, 8).astype(np.float32))
    s = torch.from_numpy(rng.randn(B, STYLE).astype(np.float32))
    layer = tl.AdaIN1d(STYLE, 8)
    mask = torch.from_numpy(_mask(30))
    seen = []

    def spy(x, *args):
        seen.append(x.is_contiguous())
        return am.adain_fold(x, *args)

    monkeypatch.setattr(tl, "adain_fold", spy)
    with torch.no_grad():
        torch.testing.assert_close(layer(x.transpose(1, 2), s, mask),
                                   layer(x.transpose(1, 2).contiguous(), s,
                                         mask), rtol=1e-6, atol=1e-6)
    assert seen == [False, True]


def _gen_block():
    net = tiny_config().istftnet
    return (GEN_CHANNELS, net.resblock_kernel_sizes[0],
            net.resblock_dilation_sizes[0])


def test_ada_snake_resblock_tiny_width():
    rng = np.random.RandomState(7)
    channels, kernel, dilations = _gen_block()
    x = rng.randn(B, 60, channels).astype(np.float32)
    s = rng.randn(B, STYLE).astype(np.float32)
    mask = _mask(60)
    fl = jl.AdaSnakeResBlock(channels, kernel, dilations, STYLE)
    pt = tl.AdaSnakeResBlock(channels, kernel, dilations, STYLE)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(mask))
    v = _shared_params(fl, pt, *args)
    out = pt(_cf(x), torch.from_numpy(s), torch.from_numpy(mask))
    _close(_cl(out), fl.apply(v, *args))


def test_ada_snake_resblock_tiny_width_bf16():
    rng = np.random.RandomState(8)
    channels, kernel, dilations = _gen_block()
    x = _bf16_values(rng.randn(B, 60, channels).astype(np.float32))
    s = _bf16_values(rng.randn(B, STYLE).astype(np.float32))
    mask = _mask(60)
    out, r16, r32 = _layer_case(
        lambda dt: jl.AdaSnakeResBlock(channels, kernel, dilations, STYLE,
                                       dtype=dt),
        tl.AdaSnakeResBlock(channels, kernel, dilations, STYLE),
        [x, s, mask], [_cf(x).bfloat16(), _t(s), _t(mask, torch.float32)])
    _check_ratio(out, r16, r32, _cl)


def test_layers_route_their_moments_through_the_pass(monkeypatch):
    """Every AdaIN of ``AdaSnakeResBlock`` (two a dilation) takes its
    scale/shift from ``adain_fold``, with the fused convs' float32 mask;
    every ``AdaIN1d`` its moments (gamma and beta None)."""
    seen = []

    def spy(x, mask, gamma, beta, extent=None):
        seen.append((tuple(x.shape), None if mask is None else mask.dtype,
                     gamma is None))
        return am.adain_fold(x, mask, gamma, beta, extent=extent)

    monkeypatch.setattr(tl, "adain_fold", spy)
    channels, kernel, dilations = _gen_block()
    rng = np.random.RandomState(9)
    s = torch.from_numpy(rng.randn(B, STYLE).astype(np.float32))
    mask = torch.from_numpy(_mask(50))
    x = torch.from_numpy(rng.randn(B, channels, 50).astype(np.float32))
    with torch.no_grad():
        tl.AdaSnakeResBlock(channels, kernel, dilations, STYLE)(x, s, mask)
        tl.AdaIN1d(STYLE, channels)(x, s, mask)
        tl.AdaIN1d(STYLE, channels)(x, s)
    assert seen == ([((B, channels, 50), torch.float32, False)]
                    * 2 * len(dilations)
                    + [((B, channels, 50), torch.float32, True),
                       ((B, channels, 50), None, True)])
