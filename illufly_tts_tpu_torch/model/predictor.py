# -*- coding: utf-8 -*-
"""Style-conditioned duration / prosody predictor (PyTorch port of
``illufly_tts_tpu/model/predictor.py``).

DurationEncoder (LSTM + AdaLayerNorm stack with style concat, [B, T, C]),
the duration projection (sigmoid-sum over max_dur bins), and ``f0n_train``
(shared BiLSTM + AdainResBlk1d towers for F0 and energy at 2x frame rate,
channels-first inside).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import KokoroConfig
from .layers import LSTM, AdaLayerNorm, AdainResBlk1d, Conv1d


class DurationEncoder(nn.Module):
    def __init__(self, cfg: KokoroConfig):
        super().__init__()
        self.style_dim = cfg.style_dim
        width = cfg.hidden_dim + cfg.style_dim
        for i in range(3):
            self.add_module(f"lstm_{i}", LSTM(width, cfg.hidden_dim // 2))
            self.add_module(f"adaln_{i}",
                            AdaLayerNorm(cfg.style_dim, cfg.hidden_dim))

    def forward(self, d_en, style, mask):
        """d_en [B, T, hidden], style [B, S] -> [B, T, hidden + S]."""
        m = mask[..., None].to(d_en.dtype)
        s_seq = style[:, None, :].expand(-1, d_en.shape[1], -1)
        x = d_en
        for i in range(3):
            x = torch.cat([x, s_seq], dim=-1) * m
            x = getattr(self, f"lstm_{i}")(x, mask)
            x = getattr(self, f"adaln_{i}")(x, style) * m
        return torch.cat([x, s_seq], dim=-1) * m


class ProsodyPredictor(nn.Module):
    def __init__(self, cfg: KokoroConfig):
        super().__init__()
        h, s = cfg.hidden_dim, cfg.style_dim
        self.duration_encoder = DurationEncoder(cfg)
        self.lstm = LSTM(h + s, h // 2)
        self.duration_proj = nn.Linear(h, cfg.max_dur)
        self.shared = LSTM(h + s, h // 2)
        for tower in ("f0", "n"):
            self.add_module(f"{tower}_0", AdainResBlk1d(h, h, s))
            self.add_module(f"{tower}_1",
                            AdainResBlk1d(h, h // 2, s, upsample=True))
            self.add_module(f"{tower}_2", AdainResBlk1d(h // 2, h // 2, s))
            self.add_module(f"{tower}_proj", Conv1d(h // 2, 1, 1))

    def encode_durations(self, d_en, style, mask):
        """-> (durations [B, T] float frames, d [B, T, hidden + style])."""
        d = self.duration_encoder(d_en, style, mask)
        logits = self.duration_proj(self.lstm(d, mask))   # [B, T, max_dur]
        duration = torch.sigmoid(logits).sum(dim=-1)
        return duration * mask.to(duration.dtype), d

    def f0n_train(self, en, style, frame_mask: Optional[torch.Tensor] = None):
        """en [B, F, hidden + style] -> (F0 [B, 2F], N [B, 2F])."""
        x = self.shared(en, frame_mask).transpose(1, 2)   # [B, H, F]

        def tower(name):
            h, m = x, frame_mask
            for i in range(3):
                block = getattr(self, f"{name}_{i}")
                h = block(h, style, m)
                if block.upsample and m is not None:
                    m = m.repeat_interleave(2, dim=1)
            return getattr(self, f"{name}_proj")(h)[:, 0, :]

        return tower("f0"), tower("n")
