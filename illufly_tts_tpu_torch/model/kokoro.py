# -*- coding: utf-8 -*-
"""KokoroModel: the full TTS stack in two stages (PyTorch port of
``illufly_tts_tpu/model/kokoro.py``).

- Stage A ``encode_durations``: shapes depend only on the token budget T;
  returns float durations + token-level hidden states.
- Stage B ``decode_frames``: everything at a fixed frame budget F, with the
  alignment as a batched gather (``ops/align.py``).
- Streaming stage B: ``decode_prepare`` once per batch (sequence-global
  state), then ``decode_window`` per window of generator frames.

Public tensors keep the JAX layouts ([B, T, C], [B, F]) so the two
packages compare like with like; the one exception is the decoder trunk's
output that ``decode_prepare`` hands to ``decode_window``, which stays in
the decoder's channels-first layout [B, C, 2F].

``config.dtype`` is the compute dtype. A bfloat16 model holds its
parameters in bfloat16 but for the float32 islands the JAX package keeps
(``to_compute_dtype``): the LayerNorms, the harmonic source, and the fused
convs' alphas and biases. It is the compute copy of a float32 model: the
engine keeps the float32 parameters and fills this copy from them after
every load (``load_state_dict`` rounds to nearest even). Inputs stay as the
engine makes them (float32 voices, masks and speeds); the style halves are
cast to the compute dtype here, as the JAX model does; durations come out
float32 (divided by the float32 speed), audio float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.align import expand_by_duration, frame_mask
from .albert import Albert
from .config import KokoroConfig, check_dtype
from .layers import AdaSnakeResBlock
from .predictor import ProsodyPredictor
from .text_encoder import TextEncoder
from .vocoder import Decoder, SourceModule


class KokoroModel(nn.Module):
    def __init__(self, config: KokoroConfig):
        super().__init__()
        check_dtype(config.dtype)
        cfg = self.config = config
        self.bert = Albert(cfg.albert)
        self.bert_encoder = nn.Linear(cfg.albert.hidden_size, cfg.hidden_dim)
        self.predictor = ProsodyPredictor(cfg)
        self.text_encoder = TextEncoder(cfg)
        self.decoder = Decoder(cfg)
        to_compute_dtype(self, cfg.dtype)

    # ---- stage A: token-length shapes only ---------------------------------

    def encode_durations(
        self,
        input_ids: torch.Tensor,    # [B, T] int, 0-padded
        mask: torch.Tensor,         # [B, T] 1=valid
        ref_s: torch.Tensor,        # [B, 2 * style_dim] voice embedding
        speed: torch.Tensor,        # [B] float
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (duration [B, T] float frames, d [B, T, hidden + style])."""
        cfg = self.config
        style = ref_s[:, cfg.style_split:].to(cfg.dtype)  # prosody half
        d_en = self.bert_encoder(self.bert(input_ids, mask))
        duration, d = self.predictor.encode_durations(d_en, style, mask)
        return duration / speed.clamp(min=1e-3)[:, None], d

    @staticmethod
    def quantize_durations(duration: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
        """round (half to even, as jnp.round) + clamp(min=1) on valid
        tokens, 0 on padding."""
        pred = torch.clamp(torch.round(duration), min=1)
        return (pred * mask).to(torch.int32)

    # ---- stage B: fixed frame budget F --------------------------------------

    def decode_frames(
        self,
        input_ids: torch.Tensor,    # [B, T]
        mask: torch.Tensor,         # [B, T]
        d: torch.Tensor,            # [B, T, hidden + style] from stage A
        pred_dur: torch.Tensor,     # [B, T] int frames
        ref_s: torch.Tensor,        # [B, 2 * style_dim]
        num_frames: int,
        generator: Optional[torch.Generator] = None,
        pcm16: bool = False,
        pitch: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (audio [B, F * 600] f32, or int16 with ``pcm16``; fmask
        [B, F])."""
        asr, f0, n_energy, fmask, dec_style = self._stage_b_front(
            input_ids, mask, d, pred_dur, ref_s, num_frames, pitch=pitch
        )
        audio = self.decoder(asr.transpose(1, 2), f0, n_energy, dec_style,
                             fmask, generator)
        sample_mask = fmask.repeat_interleave(self.config.samples_per_frame,
                                              dim=1)
        audio = audio * sample_mask
        if pcm16:
            # on-device 16-bit PCM with the WAV encoder's peak policy
            audio = torch.round(peak_normalize(audio) * 32767.0).to(
                torch.int16)
        return audio, fmask

    def _stage_b_front(self, input_ids, mask, d, pred_dur, ref_s,
                       num_frames, pitch=None):
        """Style split, duration expansion, frame mask, F0/N towers, text
        encoder alignment. -> (asr [B, F, H], f0 [B, 2F], n_energy [B, 2F],
        fmask [B, F], dec_style [B, S]). ``pitch`` [B] scales F0
        (1.0 = neutral)."""
        cfg = self.config
        style = ref_s[:, cfg.style_split:].to(cfg.dtype)
        dec_style = ref_s[:, : cfg.style_split].to(cfg.dtype)
        en = expand_by_duration(d, pred_dur, num_frames)        # [B, F, H+S]
        fmask = frame_mask(pred_dur, num_frames)                # [B, F]
        f0, n_energy = self.predictor.f0n_train(en, style, fmask)
        if pitch is not None:
            f0 = f0 * pitch[:, None].to(f0.dtype)
        t_en = self.text_encoder(input_ids, mask)               # [B, T, H]
        asr = expand_by_duration(t_en, pred_dur, num_frames)    # [B, F, H]
        return asr, f0, n_energy, fmask, dec_style

    # ---- streaming stage B: prepare once, render windows --------------------

    def decode_prepare(
        self,
        input_ids: torch.Tensor,    # [B, T]
        mask: torch.Tensor,         # [B, T]
        d: torch.Tensor,            # [B, T, hidden + style] from stage A
        pred_dur: torch.Tensor,     # [B, T] int frames
        ref_s: torch.Tensor,        # [B, 2 * style_dim]
        num_frames: int,
        pitch: Optional[torch.Tensor] = None,
    ):
        """Everything with sequence-global state, at the full frame budget:
        the prosody BiLSTM (f0n_train), the decoder trunk, and the harmonic
        source's cumulative phase. -> (x [B, C, 2F] channels-first, f0
        masked [B, 2F], cum_rad [B, 2F], mask [B, 2F]) for
        ``decode_window``."""
        cfg = self.config
        asr, f0, n_energy, fmask, dec_style = self._stage_b_front(
            input_ids, mask, d, pred_dur, ref_s, num_frames, pitch=pitch
        )
        x, f0_m, cur_mask = self.decoder.trunk(
            asr.transpose(1, 2), f0, n_energy, dec_style, fmask)
        # phase (revolutions) accumulated before each generator frame: each
        # of the 2F positions spans samples_per_frame / 2 samples of
        # constant f0
        per_pos = f0_m.float() * (cfg.samples_per_frame // 2
                                  / cfg.sample_rate)
        cum_rad = torch.cumsum(per_pos, dim=-1) - per_pos
        return x, f0_m, cum_rad, cur_mask

    def decode_window(
        self,
        x: torch.Tensor,          # [B, C, 2F] trunk output
        f0_m: torch.Tensor,       # [B, 2F]
        cum_rad: torch.Tensor,    # [B, 2F]
        cur_mask: torch.Tensor,   # [B, 2F]
        ref_s: torch.Tensor,      # [B, 2 * style_dim]
        start,                    # 0-d int tensor (or int), 2F units
        window: int,              # generator-frame units
        halo: int,                # generator-frame units
        pcm16: bool = False,
    ) -> torch.Tensor:
        """Render generator frames [start, start + window + halo) with
        ``halo`` frames of context on each side; the right halo is returned
        too, so consecutive windows overlap by ``halo`` frames for the
        caller's crossfade. -> audio [B, (window + halo) * 300].

        ``start`` is a 0-d integer tensor on ``x``'s device (a Python int
        is turned into one), as the JAX model's is a traced scalar: the
        slices are gathers at offsets clamped on the device, as
        ``dynamic_slice_in_dim`` clamps them, and nothing here reads a
        value on the host, so one captured graph serves every window
        position. The gathers (the span of x, f0, mask, the phase before
        it, the emitted audio and its mask) are a few small launches a
        window beside the Generator's.

        The generator's AdaIN layers are instance norms over time, so a
        window's statistics differ from the full render's: the output is an
        approximation that converges as windows grow. Phase (``cum_rad``)
        and conv context (the halo) are exact."""
        cfg = self.config
        dev = x.device
        start = torch.as_tensor(start, dtype=torch.int64, device=dev)
        dec_style = ref_s[:, : cfg.style_split].to(cfg.dtype)
        span = window + 2 * halo
        # no left padding (pad frames would bias-propagate through the
        # convs; clamping lets the first windows see the true start); the
        # right gets `halo` zero frames past the masked end, where the
        # full render's own zero padding lies
        total_p = x.shape[-1] + halo
        if span > total_p:
            # checked here, on the shapes: a gather past the tensor would
            # be a device-side assert, which ends the process's CUDA work
            raise ValueError(
                f"window {window} + 2 x halo {halo} generator frames exceed "
                f"the {x.shape[-1]} frames of x and its {halo}-frame right "
                "pad; use a larger frame bucket or a smaller window or halo")
        x_p = F.pad(x, (0, halo))
        f0_p, rad_p, mask_p = (F.pad(t, (0, halo))
                               for t in (f0_m, cum_rad, cur_mask))
        lo = _slice_start(start - halo, span, total_p)
        cols = lo + torch.arange(span, device=dev)
        rad0 = rad_p.index_select(1, lo[None])[:, 0]  # phase before the slice
        # no row extents: a window's rows are whole but near the end, where
        # skipping the padded columns would save little
        audio = self.decoder.generate(
            x_p.index_select(2, cols), dec_style, f0_p.index_select(1, cols),
            mask_p.index_select(1, cols), rad_offset=rad0, extents=False)
        spi = cfg.samples_per_frame // 2
        emit = window + halo  # window body + right overlap for crossfade
        a0 = _slice_start((start - lo) * spi, emit * spi, audio.shape[1])
        audio = audio.index_select(
            1, a0 + torch.arange(emit * spi, device=dev))
        m0 = _slice_start(start, emit, total_p)
        mask_w = mask_p.index_select(1, m0 + torch.arange(emit, device=dev))
        audio = audio * mask_w.repeat_interleave(spi, dim=1)
        if pcm16:
            # hard clip, not the batch path's peak normalization: the
            # stream is causal, the global peak unknown at window k, and a
            # per-window gain would pump across chunk boundaries
            audio = torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0)
            audio = audio.to(torch.int16)
        return audio


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` (the model or a part of it) cast in place to the compute
    dtype, but for the parameters a bfloat16 model keeps in float32: the
    LayerNorms' (flax normalizes in float32), the harmonic source's (JAX
    runs it in float32), and the fused convs' alphas and biases (the Pallas
    kernels take them so)."""
    if dtype == torch.float32:
        return module
    module.to(dtype)
    for mod in module.modules():
        if isinstance(mod, (nn.LayerNorm, SourceModule)):
            mod.float()
        elif isinstance(mod, AdaSnakeResBlock):
            mod.keep_f32()
    return module


def peak_normalize(audio: torch.Tensor) -> torch.Tensor:
    """The WAV encoder's peak policy, per row: scale to a peak of 1 only
    when the peak clips, then clip to [-1, 1]."""
    peak = audio.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(peak > 1.0, 1.0 / peak.clamp(min=1e-9),
                        torch.ones_like(peak))
    return torch.clamp(audio * scale, -1.0, 1.0)


def _slice_start(start: torch.Tensor, size: int,
                 total: int) -> torch.Tensor:
    """A slice start (0-d tensor) clamped into [0, total - size] on the
    device, as a JAX dynamic slice clamps it."""
    return start.clamp(min=0).clamp(max=total - size)


def _fit_durations(pred_dur: torch.Tensor, budget: int) -> torch.Tensor:
    """Clip per-item durations so cumulative frames fit the static budget."""
    cum_prev = torch.cumsum(pred_dur, dim=-1) - pred_dur
    return torch.minimum(torch.clamp(budget - cum_prev, min=0), pred_dur)
