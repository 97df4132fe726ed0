# -*- coding: utf-8 -*-
"""Foundational layers (PyTorch port of ``illufly_tts_tpu/model/layers.py``).

Layouts: the convolutional layers (``Conv1d``, ``ConvTranspose1d``,
``AdaIN1d``, ``AdainResBlk1d``, ``AdaSnakeResBlock``) work channels-first,
``[B, C, T]``, as torch's convolutions do. ``LSTM`` and ``AdaLayerNorm``
work batch-first and channels-last, ``[B, T, C]``, as ``nn.LSTM`` and
``nn.LayerNorm`` do. Masks are ``[B, T]`` with 1 = valid, and are prefix
masks everywhere in the model.

Parameter names follow the flax module names, so ``model/params.py`` maps
a flax tree onto these modules by layout alone.

bfloat16: the layers compute in the dtype of their inputs and weights (a
bfloat16 model holds bfloat16 weights, ``model/kokoro.py``). Where the JAX
package's bfloat16 differs from plain bfloat16 ops, or where rounding
after every op would lose what a float32 step keeps, a bfloat16 input is
computed in float32 and rounded once (``_wide``): the norms' moments and
affine, and the fused convs' activation and sums, as the Pallas kernels
compute them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.adain_moments import adain_fold
from ..ops.adain_snake_conv import (
    _wide,
    adain_snake_conv,
    adain_snake_conv_carry,
    pack_weights,
)


def _reverse_index(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] prefix mask -> per-row time index that reverses each row's
    valid prefix and leaves the padded tail in place (an involution)."""
    steps = mask.shape[1]
    t = torch.arange(steps, device=mask.device)
    # summed in float32: a bfloat16 sum rounds lengths above 256
    length = mask.sum(dim=1, keepdim=True, dtype=torch.float32).to(
        torch.long)
    return torch.where(t[None, :] < length, length - 1 - t[None, :],
                       t[None, :].expand(mask.shape[0], steps))


class LSTM(nn.Module):
    """Mask-aware (optionally bidirectional) LSTM, ``[B, T, D] -> [B, T,
    H * dirs]``, zero on masked steps.

    The JAX LSTM holds its carry through padded steps. With prefix masks
    that equals: the forward direction run over the padded sequence (its
    valid outputs never see the tail), and the backward direction run over
    each row's valid prefix reversed in place (``_reverse_index``), which is
    ``pack_padded_sequence`` semantics without a host-side length list.
    An all-zero mask row (batch padding) comes out as zeros.

    Flax keeps one fused bias per direction; it maps to ``bias_ih`` and
    ``bias_hh`` stays 0 (``model/params.py``)."""

    def __init__(self, input_size: int, hidden: int,
                 bidirectional: bool = True):
        super().__init__()
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        if bidirectional:
            self.bwd = nn.LSTM(input_size, hidden, batch_first=True)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        mask = mask.to(x.dtype)
        out, _ = self.fwd(x)
        if self.bidirectional:
            idx = _reverse_index(mask)[..., None]
            x_rev = torch.gather(x, 1, idx.expand(-1, -1, x.shape[-1]))
            bwd, _ = self.bwd(x_rev)
            bwd = torch.gather(bwd, 1, idx.expand(-1, -1, bwd.shape[-1]))
            out = torch.cat([out, bwd], dim=-1)
        return out * mask[..., None]


class AdaIN1d(nn.Module):
    """Style-conditioned instance norm over time. x [B, C, T], s [B, S].
    The masked moments come from the AdaIN statistics pass
    (``ops/adain_moments.py``: the kernel on CUDA). x is centered before it
    is scaled, as in the JAX layer: folded into ``x * scale + shift``, the
    backward would cancel where |mean| >> std. A bfloat16 x is normalized
    in float32 and rounded once."""

    def __init__(self, style_dim: int, channels: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x, s, mask: Optional[torch.Tensor] = None):
        gamma, beta = _wide(self.fc(s))[:, :, None].chunk(2, dim=1)
        if mask is not None:
            mask = mask.float().contiguous()
        # the kernel takes a contiguous x; on the CPU the plain moments sum
        # x as it lies (the F0/N towers hand over a transposed one)
        mean, rstd = adain_fold(x.contiguous() if x.is_cuda else x, mask,
                                None, None)
        x_norm = (_wide(x) - mean[:, :, None]) * rstd[:, :, None]
        return ((1.0 + gamma) * x_norm + beta).to(x.dtype)


class AdaLayerNorm(nn.Module):
    """Style-conditioned layer norm over channels. x [B, T, C], s [B, S];
    a bfloat16 x is normalized in float32 and rounded once."""

    def __init__(self, style_dim: int, channels: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels)

    def forward(self, x, s):
        gamma, beta = _wide(self.fc(s))[:, None, :].chunk(2, dim=-1)
        xf = _wide(x)
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        x_norm = (xf - mean) * torch.rsqrt(var + 1e-5)
        return ((1.0 + gamma) * x_norm + beta).to(x.dtype)


class Conv1d(nn.Conv1d):
    """1-D conv, channels-first, with the JAX layer's default padding
    ``((k - 1) * dilation) // 2`` on both sides (pass ``padding`` for the
    strided convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: Optional[int] = None):
        if padding is None:
            padding = ((kernel - 1) * dilation) // 2
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, dilation=dilation, groups=groups)


class ConvTranspose1d(nn.ConvTranspose1d):
    """Transposed 1-D conv with the JAX layer's geometry: padding
    ``(k - s + 1) // 2`` and output padding ``s - k + 2 * padding``, which
    give output length ``T * s`` for (20, 10), (12, 6) and the grouped
    (3, 2) pool. Flax stores its kernel unflipped and flips it in the
    forward pass; torch's transposed conv needs no flip, so the bridge is
    a transpose (``model/params.py``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, groups: int = 1):
        pad = max(0, (kernel - stride + 1) // 2)
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=pad, output_padding=stride - kernel + 2 * pad,
                         groups=groups)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x)/alpha (iSTFTNet generator)."""
    return x + (1.0 / alpha) * torch.square(torch.sin(alpha * x))


_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class AdainResBlk1d(nn.Module):
    """Style-conditioned residual block (StyleTTS2 AdainResBlk1d shape),
    channels-first. Activations are masked before every conv and pool, as
    in the JAX block."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.norm1 = AdaIN1d(style_dim, dim_in)
        if upsample:
            self.pool = ConvTranspose1d(dim_in, dim_in, 3, 2, groups=dim_in)
        self.conv1 = Conv1d(dim_in, dim_out, 3)
        self.norm2 = AdaIN1d(style_dim, dim_out)
        self.conv2 = Conv1d(dim_out, dim_out, 3)
        if dim_in != dim_out:
            self.conv1x1 = Conv1d(dim_in, dim_out, 1)
        self.learned_sc = dim_in != dim_out

    def forward(self, x, s, mask: Optional[torch.Tensor] = None):
        up_mask = None
        if mask is not None:
            up_mask = (mask.repeat_interleave(2, dim=1) if self.upsample
                       else mask)

        def m(h, up=False):
            if mask is None:
                return h
            return h * (up_mask if up else mask)[:, None, :].to(h.dtype)

        h = leaky_relu(self.norm1(x, s, mask))
        if self.upsample:
            h = self.pool(m(h))
        h = self.conv1(m(h, up=self.upsample))
        h = leaky_relu(self.norm2(h, s, up_mask))
        h = self.conv2(m(h, up=self.upsample))
        sc = m(x)
        if self.upsample:
            sc = sc.repeat_interleave(2, dim=-1)  # nearest 2x
        if self.learned_sc:
            sc = self.conv1x1(sc)
        return (h + sc) * _INV_SQRT2


class AdaSnakeResBlock(nn.Module):
    """Generator residual block: dilated convs + AdaIN + Snake
    (iSTFTNet AdaINResBlock1 shape), channels-first. The alphas are
    ``[1, C, 1]`` (flax keeps ``[1, 1, C]``).

    Each AdaIN -> snake -> mask -> conv step runs as two calls: the masked
    instance moments folded with the style affine into a per-(batch,
    channel) scale/shift (``ops/adain_moments.py``), then one fused call
    (``ops/adain_snake_conv.py``) that applies them before its conv.
    ``conv1_j`` (dilation d_j) goes to the walking-carry kernel,
    ``conv2_j`` (dilation 1) to the halo-tile kernel. As in ``AdaIN1d``,
    the moments of conv1's output are taken over the unmasked conv output
    with masked weights.

    bfloat16 (the Pallas kernels' bf16 form): x and the conv outputs are
    bfloat16; the moments, the folded scale/shift, the alphas and the conv
    biases float32 (``keep_f32``); the conv weights bfloat16, held
    stage-packed as the kernels read them (``pack_weights``), made once per
    weight.

    Under tensor parallelism (``parallel/tensor.py``) the convs are
    column-parallel and the alphas split: the moments, the AdaIN fold and
    the gathered alphas stay whole on x's device, and each conv shard runs
    the fused call at its C_out / n_model output channels on its own
    device.

    ``extent`` (int32 [B], the mask's row extents, ``mask_extent``) goes to
    both calls: the kernels then skip what the mask does not reach, with
    the same output. None (or no mask): every column."""

    def __init__(self, channels: int, kernel: int, dilations: Sequence[int],
                 style_dim: int):
        super().__init__()
        self.dilations = tuple(dilations)
        for j, d in enumerate(self.dilations):
            self.register_parameter(
                f"alpha1_{j}", nn.Parameter(torch.ones(1, channels, 1)))
            self.register_parameter(
                f"alpha2_{j}", nn.Parameter(torch.ones(1, channels, 1)))
            self.add_module(f"adain1_{j}", AdaIN1d(style_dim, channels))
            self.add_module(f"conv1_{j}",
                            Conv1d(channels, channels, kernel, dilation=d))
            self.add_module(f"adain2_{j}", AdaIN1d(style_dim, channels))
            self.add_module(f"conv2_{j}", Conv1d(channels, channels, kernel))
        # conv (or conv shard) -> (weight version, its stage-packed
        # bfloat16 weights)
        self._packed = {}

    def keep_f32(self) -> None:
        """Put the alphas and the conv biases back in float32 after the
        block was cast to bfloat16: the fused convs take them so."""
        for j in range(len(self.dilations)):
            for n in (1, 2):
                for p in (getattr(self, f"alpha{n}_{j}"),
                          getattr(self, f"conv{n}_{j}").bias):
                    p.data = p.data.float()

    def _weight(self, conv: Conv1d) -> torch.Tensor:
        """conv's weight as the fused call takes it, [k, C_in, C_out]: a
        contiguous copy per call in float32 (as ever); in bfloat16 the
        stage-packed weights ``pack_weights`` the kernels read, made again
        only when the weight changed (a load or an optimizer step), or at
        every call where the weight trains (packed with autograd on, so
        the gradient reaches it)."""
        w = conv.weight
        if w.dtype != torch.bfloat16:
            return w.permute(2, 1, 0).contiguous()
        if w.requires_grad and torch.is_grad_enabled():
            return pack_weights(w.permute(2, 1, 0))
        key = (w.data_ptr(), w._version)
        held = self._packed.get(conv)
        if held is None or held[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                held = (key, pack_weights(w.permute(2, 1, 0)))
            self._packed[conv] = held
        return held[1]

    def forward(self, x, s, mask: Optional[torch.Tensor] = None,
                extent: Optional[torch.Tensor] = None):
        if mask is None:
            extent = None
            mask = torch.ones(x.shape[0], x.shape[2], dtype=x.dtype,
                              device=x.device)
        kernel_mask = mask.float().contiguous()  # the fused convs' mask
        mask = mask.to(x.dtype).contiguous()

        def step(fused, h, j, n):
            adain = getattr(self, f"adain{n}_{j}")
            conv = getattr(self, f"conv{n}_{j}")
            alpha = getattr(self, f"alpha{n}_{j}")
            if isinstance(alpha, nn.Module):  # split: gathered here
                alpha = alpha(h.device)
            gamma, beta = _wide(adain.fc(s)).chunk(2, dim=1)
            scale, shift = adain_fold(h, kernel_mask, gamma, beta,
                                      extent=extent)
            inputs = (h, kernel_mask, scale, shift, alpha.reshape(-1))
            # a column-parallel conv (parallel/tensor.py): each shard runs
            # the fused call on its device at its output channels, from the
            # whole input; the slices are gathered on h's device
            parts = [fused(*(t.to(c.weight.device) for t in inputs),
                           self._weight(c), c.bias, c.kernel_size[0],
                           c.dilation[0],
                           extent=None if extent is None
                           else extent.to(c.weight.device)).to(h.device)
                     for c in getattr(conv, "shards", (conv,))]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

        for j in range(len(self.dilations)):
            h = step(adain_snake_conv_carry, x, j, 1)
            h = step(adain_snake_conv, h, j, 2)
            x = (x + h) * mask[:, None, :]
        return x
