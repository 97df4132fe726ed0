# -*- coding: utf-8 -*-
"""iSTFTNet-style decoder (PyTorch port of ``illufly_tts_tpu/model/vocoder.py``):
AdaIN residual decode stack + harmonic-source generator emitting the
waveform through the tiny iSTFT head. Channels-first inside.

The Generator always ends in ``ops/istft_oa.py::istft_head`` — one CUDA
kernel from conv_post's raw output to audio on the card, its plain version
on the CPU — which is the counterpart of the JAX ``use_pallas_istft=True``
setting (its exp/clip and pi * sin head included).

In bfloat16, as the JAX Generator: the harmonic source runs in float32,
its ``merge`` Dense included (``SourceModule`` stays float32), and its
output and the harmonic spectrum are rounded to bfloat16; conv_post's
bfloat16 output goes to the head, which computes in float32, so audio is
float32 in either dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.adain_snake_conv import mask_extent
from ..ops.istft_oa import istft_head
from ..ops.stft import stft_magphase
from .config import KokoroConfig
from .layers import (
    AdainResBlk1d,
    AdaSnakeResBlock,
    Conv1d,
    ConvTranspose1d,
    leaky_relu,
)


class SourceModule(nn.Module):
    """Harmonic-plus-noise source (SourceModuleHnNSF role)."""

    def __init__(self, sample_rate: int, harmonics: int = 8,
                 voiced_threshold: float = 10.0, sine_amp: float = 0.1,
                 noise_std: float = 0.003):
        super().__init__()
        self.sample_rate = sample_rate
        self.harmonics = harmonics
        self.voiced_threshold = voiced_threshold
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.merge = nn.Linear(harmonics + 1, 1)

    def forward(self, f0_up: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rad_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f0_up [B, L] (Hz per sample) -> harmonic source [B, L].

        ``generator`` given: add the SineGen noise (voiced dither
        ``noise_std``, unvoiced ``sine_amp / 3``), drawn from it. The main
        path passes none and is deterministic. ``rad_offset`` [B]: the
        phase (in revolutions) accumulated before this window, which keeps
        the windowed stream phase-continuous with the full render."""
        h = torch.arange(1, self.harmonics + 2, dtype=torch.float32,
                         device=f0_up.device)
        # phase accumulates in f32: cumsum of instantaneous frequency
        rad = torch.cumsum(f0_up.float() / self.sample_rate, dim=-1)
        if rad_offset is not None:
            rad = rad + rad_offset.float()[:, None]
        phase = 2.0 * math.pi * rad[..., None] * h
        uv = (f0_up > self.voiced_threshold).float()[..., None]
        sines = self.sine_amp * torch.sin(phase) * uv
        if generator is not None:
            noise_std = uv * self.noise_std + (1 - uv) * (self.sine_amp / 3.0)
            sines = sines + noise_std * torch.randn(
                sines.shape, generator=generator, device=sines.device)
        return torch.tanh(self.merge(sines))[..., 0]


class Generator(nn.Module):
    def __init__(self, cfg: KokoroConfig, in_channels: int):
        super().__init__()
        net = cfg.istftnet
        self.n_fft, self.hop = net.gen_istft_n_fft, net.gen_istft_hop_size
        self.upsample_rates = tuple(net.upsample_rates)
        self.num_kernels = len(net.resblock_kernel_sizes)
        self.up_total = math.prod(self.upsample_rates)
        self.source = SourceModule(cfg.sample_rate)
        spec = self.n_fft + 2
        ch = net.upsample_initial_channel
        c_prev = in_channels
        for i, (u, k) in enumerate(zip(self.upsample_rates,
                                       net.upsample_kernel_sizes)):
            c_cur = ch // (2 ** (i + 1))
            self.add_module(f"up_{i}", ConvTranspose1d(c_prev, c_cur, k, u))
            if i + 1 < len(self.upsample_rates):
                stride_f0 = math.prod(self.upsample_rates[i + 1:])
                self.add_module(f"noise_conv_{i}", Conv1d(
                    spec, c_cur, stride_f0 * 2, stride=stride_f0,
                    padding=(stride_f0 + 1) // 2))  # torch istftnet geometry
                self.add_module(f"noise_res_{i}", AdaSnakeResBlock(
                    c_cur, 7, (1, 3, 5), cfg.style_dim))
            else:
                self.add_module(f"noise_conv_{i}", Conv1d(spec, c_cur, 1))
                self.add_module(f"noise_res_{i}", AdaSnakeResBlock(
                    c_cur, 11, (1, 3, 5), cfg.style_dim))
            for j, (kr, dr) in enumerate(zip(net.resblock_kernel_sizes,
                                             net.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", AdaSnakeResBlock(
                    c_cur, kr, tuple(dr), cfg.style_dim))
            c_prev = c_cur
        self.conv_post = Conv1d(c_prev, spec, 7)

    def forward(self, x, s, f0, mask=None, generator=None, rad_offset=None,
                extents=True):
        """x [B, C0, 2F], s [B, S], f0 [B, 2F] -> audio [B, 2F * 300].
        ``rad_offset`` [B]: see ``SourceModule``. ``extents`` False: the
        blocks get no row extents and compute every column (for a caller
        whose rows are whole but for rare ones, as stream windows are)."""
        n_fft, hop = self.n_fft, self.hop
        if mask is not None:
            f0 = f0 * mask.to(f0.dtype)
            x = x * mask[:, None, :].to(x.dtype)

        # harmonic source at the sample rate
        f0_up = f0.repeat_interleave(self.up_total * hop, dim=1)  # [B, L]
        har = self.source(f0_up, generator, rad_offset).to(x.dtype)
        # pad so the harmonic frame count == x length * up_total
        har = F.pad(har[:, None, :], (0, n_fft - hop), mode="reflect")[:, 0]
        mag_h, ph_h = stft_magphase(har.float(), n_fft, hop)
        har_spec = torch.cat([mag_h, ph_h], dim=-1).transpose(1, 2).to(
            x.dtype)

        cur_mask, extent = mask, None
        for i, u in enumerate(self.upsample_rates):
            x = getattr(self, f"up_{i}")(leaky_relu(x, 0.1))
            if cur_mask is not None:
                cur_mask = cur_mask.repeat_interleave(u, dim=1)
                x = x * cur_mask[:, None, :].to(x.dtype)
                # each row's mask extent, once a stage: the stage's bf16
                # blocks compute no columns past it and its conv's reach
                # (the float32 convs compute every column: none there)
                if extents and x.dtype == torch.bfloat16:
                    extent = mask_extent(cur_mask)
            # noise branch from the harmonic spectrum
            x_src = getattr(self, f"noise_conv_{i}")(har_spec)
            x = x + getattr(self, f"noise_res_{i}")(x_src, s, cur_mask,
                                                    extent)
            acc = None
            for j in range(self.num_kernels):
                out = getattr(self, f"res_{i}_{j}")(x, s, cur_mask, extent)
                acc = out if acc is None else acc + out
            x = acc / self.num_kernels

        # conv_post's raw [B, n_fft + 2, L'] goes straight into the head
        # kernel (exp/clip, pi * sin and the iSTFT in one launch, float32
        # audio from float32 or bfloat16); the output is already F * hop
        return istft_head(self.conv_post(leaky_relu(x, 0.01)), n_fft, hop)


class Decoder(nn.Module):
    """Trunk (frame-rate AdaIN conv stack) + Generator; ``trunk`` and
    ``generate`` are separately callable, as in the JAX decoder."""

    _SPECS = ((1024 + 2 + 64, 1024, False),) * 3 + ((1024 + 2 + 64, 512, True),)

    def __init__(self, cfg: KokoroConfig):
        super().__init__()
        h, s = cfg.hidden_dim, cfg.style_dim
        self.f0_conv = Conv1d(1, 1, 3, stride=2)
        self.n_conv = Conv1d(1, 1, 3, stride=2)
        self.encode = AdainResBlk1d(h + 2, 1024, s)
        self.asr_res = Conv1d(h, 64, 1)
        for i, (dim_in, dim_out, upsample) in enumerate(self._SPECS):
            self.add_module(f"decode_{i}",
                            AdainResBlk1d(dim_in, dim_out, s, upsample))
        self.generator = Generator(cfg, self._SPECS[-1][1])

    def trunk(self, asr, f0_curve, n_curve, s, frame_mask=None):
        """asr [B, H, F], f0/n [B, 2F] -> (x [B, 512, 2F], f0 masked [B, 2F],
        mask [B, 2F])."""
        if frame_mask is not None:
            mask2 = frame_mask.repeat_interleave(2, dim=1).to(f0_curve.dtype)
            f0_curve = f0_curve * mask2
            n_curve = n_curve * mask2
        f0 = self.f0_conv(f0_curve[:, None, :])
        n = self.n_conv(n_curve[:, None, :])
        x = self.encode(torch.cat([asr, f0, n], dim=1), s, frame_mask)
        asr_res = self.asr_res(asr)
        residual = True
        cur_mask = frame_mask
        for i, (_, _, upsample) in enumerate(self._SPECS):
            if residual:
                x = torch.cat([x, asr_res, f0, n], dim=1)
            x = getattr(self, f"decode_{i}")(x, s, cur_mask)
            if upsample:
                residual = False
                if cur_mask is not None:
                    cur_mask = cur_mask.repeat_interleave(2, dim=1)
        return x, f0_curve, cur_mask

    def generate(self, x, s, f0_curve, cur_mask=None, generator=None,
                 rad_offset=None, extents=True):
        return self.generator(x, s, f0_curve, cur_mask, generator,
                              rad_offset, extents)

    def forward(self, asr, f0_curve, n_curve, s, frame_mask=None,
                generator=None):
        """asr [B, H, F], f0/n [B, 2F], s [B, S] -> audio [B, F * 600]."""
        x, f0_curve, cur_mask = self.trunk(asr, f0_curve, n_curve, s,
                                           frame_mask)
        return self.generate(x, s, f0_curve, cur_mask, generator)
