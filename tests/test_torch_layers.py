# -*- coding: utf-8 -*-
"""PyTorch port: every layer of ``model/layers.py`` against its flax twin.

Both get the same parameters (flax init, then every leaf replaced by seeded
numpy values and carried over by the weight bridge) and the same seeded
inputs, with padded batch rows and one all-zero mask row. f32 on the CPU;
tolerance atol 1e-5 / rtol 1e-4 (the two frameworks sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.model import layers as jl
from illufly_tts_tpu_torch.model import layers as tl
from illufly_tts_tpu_torch.model.params import load_flax_params

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
B, T, S = 3, 24, 8


def _mask(steps=T):
    lengths = np.array([steps, steps - 7, 0])  # full, padded, all-zero
    return (np.arange(steps)[None, :] < lengths[:, None]).astype(np.float32)


def _shared_params(flax_mod, port_mod, *args, seed=0):
    """Init ``flax_mod`` on ``args``, replace every leaf by seeded values
    (alphas positive), load them into ``port_mod``; -> flax variables."""
    variables = flax_mod.init(jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = "/".join(str(p.key) for p in path)
        vals = rng.randn(*leaf.shape).astype(np.float32) * 0.3
        if "alpha" in name:
            vals = np.abs(vals) + 0.5
        return jnp.asarray(vals)

    variables = jax.tree_util.tree_map_with_path(fill, variables)
    load_flax_params(port_mod, jax.tree_util.tree_map(np.asarray, variables))
    return variables


def _close(port_out, flax_out):
    np.testing.assert_allclose(port_out.detach().numpy(),
                               np.asarray(flax_out), atol=ATOL, rtol=RTOL)


def _cf(x):  # [B, T, C] numpy -> port channels-first tensor
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 1))))


def _cl(y):  # port [B, C, T] -> [B, T, C] tensor
    return y.transpose(1, 2)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm(bidirectional):
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, 6).astype(np.float32)
    mask = _mask()
    fl = jl.LSTM(5, bidirectional=bidirectional)
    pt = tl.LSTM(6, 5, bidirectional=bidirectional)
    v = _shared_params(fl, pt, jnp.asarray(x), jnp.asarray(mask))
    ref = fl.apply(v, jnp.asarray(x), jnp.asarray(mask))
    _close(pt(torch.from_numpy(x), torch.from_numpy(mask)), ref)
    # no mask = all valid
    _close(pt(torch.from_numpy(x)), fl.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("masked", [True, False])
def test_adain1d(masked):
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, 7).astype(np.float32) * 2 + 1
    s = rng.randn(B, S).astype(np.float32)
    mask = _mask() if masked else None
    fl, pt = jl.AdaIN1d(7), tl.AdaIN1d(S, 7)
    jm = None if mask is None else jnp.asarray(mask)
    v = _shared_params(fl, pt, jnp.asarray(x), jnp.asarray(s), jm)
    ref = fl.apply(v, jnp.asarray(x), jnp.asarray(s), jm)
    out = pt(_cf(x), torch.from_numpy(s),
             None if mask is None else torch.from_numpy(mask))
    _close(_cl(out), ref)


def test_ada_layer_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, 10).astype(np.float32)
    s = rng.randn(B, S).astype(np.float32)
    fl, pt = jl.AdaLayerNorm(10), tl.AdaLayerNorm(S, 10)
    v = _shared_params(fl, pt, jnp.asarray(x), jnp.asarray(s))
    _close(pt(torch.from_numpy(x), torch.from_numpy(s)),
           fl.apply(v, jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("k,stride,dilation,padding,steps", [
    (3, 1, 1, None, T), (7, 1, 3, None, T), (11, 1, 5, None, T),
    (5, 1, 1, None, T), (1, 1, 1, None, T),
    (12, 6, 1, 3, 60),   # noise_conv_0: the harmonic spectrum, stride 6
    (3, 2, 1, 1, T),     # f0_conv / n_conv
])
def test_conv1d(k, stride, dilation, padding, steps):
    rng = np.random.RandomState(4)
    x = rng.randn(B, steps, 6).astype(np.float32)
    fl = jl.Conv1d(5, k, stride=stride, dilation=dilation, padding=padding)
    pt = tl.Conv1d(6, 5, k, stride=stride, dilation=dilation,
                   padding=padding)
    v = _shared_params(fl, pt, jnp.asarray(x))
    ref = fl.apply(v, jnp.asarray(x))
    out = _cl(pt(_cf(x)))
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("k,stride,groups", [(20, 10, 1), (12, 6, 1),
                                             (3, 2, 8)])
def test_conv_transpose1d(k, stride, groups):
    rng = np.random.RandomState(5)
    c_in = 8
    c_out = c_in if groups > 1 else 6
    x = rng.randn(B, 12, c_in).astype(np.float32)
    fl = jl.ConvTranspose1d(c_out, kernel=k, stride=stride, groups=groups)
    pt = tl.ConvTranspose1d(c_in, c_out, k, stride, groups=groups)
    v = _shared_params(fl, pt, jnp.asarray(x))
    ref = fl.apply(v, jnp.asarray(x))
    out = _cl(pt(_cf(x)))
    assert tuple(out.shape) == ref.shape == (B, 12 * stride, c_out)
    _close(out, ref)


def test_activations():
    rng = np.random.RandomState(6)
    x = rng.randn(4, 50).astype(np.float32) * 3
    alpha = np.abs(rng.randn(1, 50)).astype(np.float32) + 0.2
    _close(tl.leaky_relu(torch.from_numpy(x)), jl.leaky_relu(jnp.asarray(x)))
    _close(tl.leaky_relu(torch.from_numpy(x), 0.01),
           jl.leaky_relu(jnp.asarray(x), 0.01))
    _close(tl.snake(torch.from_numpy(x), torch.from_numpy(alpha)),
           jl.snake(jnp.asarray(x), jnp.asarray(alpha)))


@pytest.mark.parametrize("dim_in,dim_out,upsample", [
    (6, 6, False), (6, 4, False), (6, 4, True),
])
def test_adain_resblk1d(dim_in, dim_out, upsample):
    rng = np.random.RandomState(7)
    x = rng.randn(B, T, dim_in).astype(np.float32)
    s = rng.randn(B, S).astype(np.float32)
    mask = _mask()
    fl = jl.AdainResBlk1d(dim_in, dim_out, S, upsample=upsample)
    pt = tl.AdainResBlk1d(dim_in, dim_out, S, upsample=upsample)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(mask))
    v = _shared_params(fl, pt, *args)
    ref = fl.apply(v, *args)
    out = _cl(pt(_cf(x), torch.from_numpy(s), torch.from_numpy(mask)))
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("kernel,dilations", [(3, (1, 3, 5)), (7, (1, 3)),
                                              (11, (1, 3, 5))])
def test_ada_snake_resblock(kernel, dilations):
    rng = np.random.RandomState(8)
    x = rng.randn(B, 40, 6).astype(np.float32)
    s = rng.randn(B, S).astype(np.float32)
    mask = _mask(40)
    fl = jl.AdaSnakeResBlock(6, kernel, dilations, S)
    pt = tl.AdaSnakeResBlock(6, kernel, dilations, S)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(mask))
    v = _shared_params(fl, pt, *args)
    ref = fl.apply(v, *args)
    out = _cl(pt(_cf(x), torch.from_numpy(s), torch.from_numpy(mask)))
    _close(out, ref)
