# -*- coding: utf-8 -*-
"""KokoroModel: the full TTS stack in two stages (PyTorch port of
``illufly_tts_tpu/model/kokoro.py``).

- Stage A ``encode_durations``: shapes depend only on the token budget T;
  returns float durations + token-level hidden states.
- Stage B ``decode_frames``: everything at a fixed frame budget F, with the
  alignment as a batched gather (``ops/align.py``).

Public tensors keep the JAX layouts ([B, T, C], [B, F]) so the two
packages compare like with like.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.align import expand_by_duration, frame_mask
from .albert import Albert
from .config import KokoroConfig
from .predictor import ProsodyPredictor
from .text_encoder import TextEncoder
from .vocoder import Decoder


class KokoroModel(nn.Module):
    def __init__(self, config: KokoroConfig):
        super().__init__()
        cfg = self.config = config
        self.bert = Albert(cfg.albert)
        self.bert_encoder = nn.Linear(cfg.albert.hidden_size, cfg.hidden_dim)
        self.predictor = ProsodyPredictor(cfg)
        self.text_encoder = TextEncoder(cfg)
        self.decoder = Decoder(cfg)

    # ---- stage A: token-length shapes only ---------------------------------

    def encode_durations(
        self,
        input_ids: torch.Tensor,    # [B, T] int, 0-padded
        mask: torch.Tensor,         # [B, T] 1=valid
        ref_s: torch.Tensor,        # [B, 2 * style_dim] voice embedding
        speed: torch.Tensor,        # [B] float
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (duration [B, T] float frames, d [B, T, hidden + style])."""
        style = ref_s[:, self.config.style_split:]       # prosody half
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
            # on-device 16-bit PCM with the WAV encoder's peak policy:
            # normalize only when the peak clips
            peak = audio.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(peak > 1.0, 1.0 / peak.clamp(min=1e-9),
                                torch.ones_like(peak))
            audio = torch.clamp(audio * scale, -1.0, 1.0)
            audio = torch.round(audio * 32767.0).to(torch.int16)
        return audio, fmask

    def _stage_b_front(self, input_ids, mask, d, pred_dur, ref_s,
                       num_frames, pitch=None):
        """Style split, duration expansion, frame mask, F0/N towers, text
        encoder alignment. -> (asr [B, F, H], f0 [B, 2F], n_energy [B, 2F],
        fmask [B, F], dec_style [B, S]). ``pitch`` [B] scales F0
        (1.0 = neutral)."""
        cfg = self.config
        style = ref_s[:, cfg.style_split:]
        dec_style = ref_s[:, : cfg.style_split]
        en = expand_by_duration(d, pred_dur, num_frames)        # [B, F, H+S]
        fmask = frame_mask(pred_dur, num_frames)                # [B, F]
        f0, n_energy = self.predictor.f0n_train(en, style, fmask)
        if pitch is not None:
            f0 = f0 * pitch[:, None].to(f0.dtype)
        t_en = self.text_encoder(input_ids, mask)               # [B, T, H]
        asr = expand_by_duration(t_en, pred_dur, num_frames)    # [B, F, H]
        return asr, f0, n_energy, fmask, dec_style


def _fit_durations(pred_dur: torch.Tensor, budget: int) -> torch.Tensor:
    """Clip per-item durations so cumulative frames fit the static budget."""
    cum_prev = torch.cumsum(pred_dur, dim=-1) - pred_dur
    return torch.minimum(torch.clamp(budget - cum_prev, min=0), pred_dur)
