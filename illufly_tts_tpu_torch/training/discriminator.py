# -*- coding: utf-8 -*-
"""Waveform discriminators for adversarial training (HiFi-GAN recipe): the
PyTorch port of ``illufly_tts_tpu/training/discriminator.py``.

- ``PeriodDiscriminator`` (HiFi-GAN's multi-period member): the waveform
  folds into a ``[B, 1, S/p, p]`` image per period p and runs a strided
  conv stack.
- ``ResolutionDiscriminator`` (UnivNet/BigVGAN-style): a conv stack over the
  STFT magnitude ``[B, 1, T, bins]`` at one resolution, through the same
  ``ops/stft.stft_magphase`` the reconstruction losses use.
- ``HiFiGANDiscriminator``: every period and resolution; returns (logits
  per member, feature maps per member).

Flax's NHWC ``Conv`` becomes NCHW ``nn.Conv2d``; ``padding="SAME"`` (which
pads ``total // 2`` before and the rest after) is applied by ``_same_pad``.
Submodules carry the flax names (``period_2``, ``res_512``, ``Conv_0``...),
so ``load_flax_disc_params`` / ``export_flax_disc_params`` bridge a flax
discriminator tree by layout alone: kernel ``[kh, kw, in, out]`` <->
``[out, in, kh, kw]``. ``init_disc_params`` draws the port's own init
(normal with variance 1/fan_in, zero biases, from a torch generator): the
flax init (truncated lecun-normal from a JAX key) is not reproduced.

The leaky ReLUs are ``model/layers.leaky_relu`` (slope 1 at 0, as flax's
``jnp.where(x >= 0, ...)``; ``F.leaky_relu`` takes the slope there, and a
masked waveform through zero biases puts many activations at exactly 0).

LSGAN losses follow HiFi-GAN eq. (1)-(3): D minimizes (1-D(y))^2 +
D(G(x))^2, G minimizes (1-D(G(x)))^2 plus L1 feature matching over every
intermediate activation.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model.layers import leaky_relu
from ..model.params import _flatten, _nest
from ..ops.stft import stft_magphase


def _same_pad(h: torch.Tensor, kernel: Tuple[int, int],
              stride: Tuple[int, int]) -> torch.Tensor:
    """Pad [B, C, H, W] as flax's ``padding="SAME"``: out = ceil(in / s),
    ``total // 2`` before and the rest after, per dimension."""
    pads = []
    for size, k, s in zip(h.shape[2:], kernel, stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return F.pad(h, (left, right, top, bottom))


class PeriodDiscriminator(nn.Module):
    """One period's fold-and-conv stack. Input ``[B, S]`` waveform."""

    def __init__(self, period: int, base_channels: int = 32,
                 max_channels: int = 256, n_layers: int = 4):
        super().__init__()
        self.period = period
        self.n_layers = n_layers
        ch_in, ch = 1, base_channels
        for i in range(n_layers):
            self.add_module(f"Conv_{i}", nn.Conv2d(
                ch_in, ch, (5, 1), stride=(3, 1), padding=(2, 0)))
            ch_in, ch = ch, min(ch * 4, max_channels)
        self.add_module(f"Conv_{n_layers}", nn.Conv2d(
            ch_in, max_channels, (5, 1), padding=(2, 0)))
        self.add_module(f"Conv_{n_layers + 1}", nn.Conv2d(
            max_channels, 1, (3, 1), padding=(1, 0)))

    def forward(self, x: torch.Tensor):
        b, s = x.shape
        pad = (-s) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        h = x.reshape(b, 1, -1, self.period)  # [B, 1, S/p, p]
        feats = []
        for i in range(self.n_layers + 2):
            h = getattr(self, f"Conv_{i}")(h)
            if i <= self.n_layers:
                h = leaky_relu(h, 0.1)
            feats.append(h)
        return h.reshape(b, -1), feats


class ResolutionDiscriminator(nn.Module):
    """Conv stack over one STFT-magnitude image ``[B, 1, T, bins]``."""

    STRIDES = ((1, 2), (1, 2), (2, 2), (1, 1))

    def __init__(self, n_fft: int, hop: int, channels: int = 32):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        ch_in = 1
        for i in range(len(self.STRIDES)):
            self.add_module(f"Conv_{i}", nn.Conv2d(ch_in, channels, (3, 9),
                                                   stride=self.STRIDES[i]))
            ch_in = channels
        self.add_module(f"Conv_{len(self.STRIDES)}",
                        nn.Conv2d(channels, 1, (3, 3)))

    def forward(self, x: torch.Tensor):
        mag, _ = stft_magphase(x, self.n_fft, self.hop)  # [B, T, bins]
        h = mag[:, None]
        feats = []
        for i, stride in enumerate(self.STRIDES + ((1, 1),)):
            conv = getattr(self, f"Conv_{i}")
            h = conv(_same_pad(h, conv.kernel_size, stride))
            if i < len(self.STRIDES):
                h = leaky_relu(h, 0.1)
            feats.append(h)
        return h.reshape(x.shape[0], -1), feats


class HiFiGANDiscriminator(nn.Module):
    """The full ensemble: every member scores the waveform; returns (list
    of per-member logits, list of per-member feature lists)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 resolutions: Sequence[Tuple[int, int]] = (
                     (512, 128), (1024, 256), (2048, 512)),
                 base_channels: int = 32, max_channels: int = 256):
        super().__init__()
        self.members = [f"period_{p}" for p in periods] + [
            f"res_{n_fft}" for n_fft, _ in resolutions]
        for p in periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(
                p, base_channels, max_channels))
        for n_fft, hop in resolutions:
            self.add_module(f"res_{n_fft}", ResolutionDiscriminator(
                n_fft, hop, base_channels))

    def forward(self, x: torch.Tensor):
        logits, feats = [], []
        for name in self.members:
            lo, fe = getattr(self, name)(x)
            logits.append(lo)
            feats.append(fe)
        return logits, feats


# --------------------------------------------------------------------------
# the flax weight bridge and the port's init
# --------------------------------------------------------------------------

_KERNEL_PERM = (3, 2, 0, 1)  # flax [kh, kw, in, out] -> torch [out, in, kh, kw]


def _specs(disc: nn.Module):
    for name, mod in disc.named_modules():
        if isinstance(mod, nn.Conv2d):
            path = tuple(name.split("."))
            yield mod, path


def load_flax_disc_params(disc: nn.Module, tree: Mapping) -> None:
    """Fill ``disc`` from a flax ``HiFiGANDiscriminator`` tree
    (``{"params": ...}`` or its inner dict). Raises ValueError on any leaf
    it cannot place or any it misses."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    wanted = set()
    with torch.no_grad():
        for mod, path in _specs(disc):
            for leaf, param, perm in (("kernel", mod.weight, _KERNEL_PERM),
                                      ("bias", mod.bias, None)):
                wanted.add(path + (leaf,))
                if path + (leaf,) not in flat:
                    raise ValueError(f"missing leaf {'/'.join(path)}/{leaf}")
                arr = flat[path + (leaf,)]
                arr = arr.transpose(perm) if perm else arr
                if tuple(arr.shape) != tuple(param.shape):
                    raise ValueError(f"{'/'.join(path)}/{leaf}: shape "
                                     f"{arr.shape} != {tuple(param.shape)}")
                param.copy_(torch.tensor(arr))
    extra = sorted("/".join(p) for p in set(flat) - wanted)
    if extra:
        raise ValueError(f"unmapped discriminator leaves {extra}")


def export_flax_disc_params(disc: nn.Module, grads: bool = False) -> dict:
    """``disc``'s weights (``grads``: their ``.grad``) as a flax-layout
    ``{"params": ...}`` tree of numpy arrays."""
    flat = {}
    for mod, path in _specs(disc):
        for leaf, param, perm in (("kernel", mod.weight, _KERNEL_PERM),
                                  ("bias", mod.bias, None)):
            t = param.grad if grads else param
            arr = (np.zeros(param.shape, np.float32) if t is None
                   else t.detach().cpu().float().numpy())
            flat[path + (leaf,)] = np.ascontiguousarray(
                arr.transpose(np.argsort(perm)) if perm else arr)
    return {"params": _nest(flat)}


@torch.no_grad()
def init_disc_params(disc: nn.Module, seed: int) -> None:
    """Kernels ~ N(0, 1/fan_in), biases 0, from ``torch.Generator`` seeded
    with ``seed`` (on the host, then copied to the parameters' device)."""
    gen = torch.Generator().manual_seed(seed)
    for mod, _ in _specs(disc):
        fan_in = math.prod(mod.weight.shape[1:])
        mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                         / math.sqrt(fan_in))
        mod.bias.zero_()


# --------------------------------------------------------------------------
# LSGAN losses (HiFi-GAN eq. 1-3)
# --------------------------------------------------------------------------

def discriminator_loss(real_logits, fake_logits) -> torch.Tensor:
    total = 0.0
    for r, f in zip(real_logits, fake_logits):
        total = total + torch.mean(torch.square(1.0 - r)) + torch.mean(
            torch.square(f))
    return total


def generator_adv_loss(fake_logits) -> torch.Tensor:
    total = 0.0
    for f in fake_logits:
        total = total + torch.mean(torch.square(1.0 - f))
    return total


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    total = 0.0
    count = 0
    for r_list, f_list in zip(real_feats, fake_feats):
        for r, f in zip(r_list, f_list):
            total = total + torch.mean(torch.abs(r - f))
            count += 1
    return total / max(count, 1)
