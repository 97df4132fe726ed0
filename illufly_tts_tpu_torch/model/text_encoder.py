# -*- coding: utf-8 -*-
"""Text encoder: phoneme embedding -> convs -> BiLSTM (PyTorch port of
``illufly_tts_tpu/model/text_encoder.py``). [B, T] ids -> [B, T, hidden]."""
from __future__ import annotations

import torch
from torch import nn

from .albert import LN_EPS, layer_norm
from .config import KokoroConfig
from .layers import LSTM, Conv1d, leaky_relu


class TextEncoder(nn.Module):
    def __init__(self, cfg: KokoroConfig):
        super().__init__()
        h = cfg.hidden_dim
        self.n_layer = cfg.n_layer
        self.embed = nn.Embedding(cfg.n_token, h)
        for i in range(cfg.n_layer):
            self.add_module(f"conv_{i}",
                            Conv1d(h, h, cfg.text_encoder_kernel_size))
            self.add_module(f"ln_{i}", nn.LayerNorm(h, eps=LN_EPS))
        self.lstm = LSTM(h, h // 2)

    def forward(self, input_ids: torch.Tensor, mask: torch.Tensor):
        x = self.embed(input_ids).transpose(1, 2)             # [B, H, T]
        m = mask[:, None, :].to(x.dtype)                      # [B, 1, T]
        for i in range(self.n_layer):
            x = getattr(self, f"conv_{i}")(x * m)
            x = layer_norm(getattr(self, f"ln_{i}"),
                           x.transpose(1, 2)).transpose(1, 2)
            x = leaky_relu(x) * m
        x = self.lstm(x.transpose(1, 2), mask)                # [B, T, H]
        return x * m.transpose(1, 2)
