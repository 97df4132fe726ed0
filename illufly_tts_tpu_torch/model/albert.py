# -*- coding: utf-8 -*-
"""ALBERT phoneme encoder (PyTorch port of ``illufly_tts_tpu/model/albert.py``).

Factorized embedding (vocab -> E -> hidden) + ONE transformer layer applied
``num_layers`` times, an additive -1e9 mask, tanh-approximate GELU, and
LayerNorm eps 1e-6 (flax's default; torch's is 1e-5). Layout [B, T, C].
In bfloat16, as flax's ``dtype=bf16``: the softmax and the LayerNorms run
in float32 (their parameters stay float32), the rest in bfloat16.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.adain_snake_conv import _wide
from .config import AlbertConfig

LN_EPS = 1e-6  # flax nn.LayerNorm default


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln(x)`` in float32, rounded to x's dtype (flax's LayerNorm with a
    bfloat16 dtype computes in float32)."""
    return ln(_wide(x)).to(x.dtype)


class AlbertLayer(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.attn_out = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln_attn = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln_ffn = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor):
        batch, steps, width = x.shape
        head_dim = width // self.num_heads
        q, k, v = (
            t.reshape(batch, steps, self.num_heads, head_dim).transpose(1, 2)
            for t in self.qkv(x).chunk(3, dim=-1)
        )  # [B, H, T, D]
        logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(head_dim))
        probs = torch.softmax((logits + attn_bias).float(), dim=-1)
        ctx = (probs.to(x.dtype) @ v).transpose(1, 2).reshape(x.shape)
        x = layer_norm(self.ln_attn, x + self.attn_out(ctx))
        h = nn.functional.gelu(self.ffn_in(x), approximate="tanh")
        return layer_norm(self.ln_ffn, x + self.ffn_out(h))


class Albert(nn.Module):
    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.num_layers = cfg.num_layers
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.embedding_size)
        self.pos_emb = nn.Parameter(
            torch.zeros(cfg.max_position, cfg.embedding_size))
        self.ln_emb = nn.LayerNorm(cfg.embedding_size, eps=LN_EPS)
        self.emb_proj = nn.Linear(cfg.embedding_size, cfg.hidden_size)
        self.shared_layer = AlbertLayer(cfg)

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, steps = input_ids.shape
        if mask is None:
            mask = torch.ones((batch, steps), device=input_ids.device)
        emb = self.tok_emb(input_ids) + self.pos_emb[None, :steps, :]
        x = self.emb_proj(layer_norm(self.ln_emb, emb))
        attn_bias = torch.where(
            mask[:, None, None, :] > 0, 0.0, -1e9).to(x.dtype)
        for _ in range(self.num_layers):  # shared parameters (ALBERT)
            x = self.shared_layer(x, attn_bias)
        return x * mask[..., None].to(x.dtype)
