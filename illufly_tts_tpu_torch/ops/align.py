# -*- coding: utf-8 -*-
"""Batched duration -> frame alignment (PyTorch port of
``illufly_tts_tpu/ops/align.py``).

Frame j belongs to token i iff cumsum(d)[i-1] <= j < cumsum(d)[i]. The JAX
version counts boundaries with a [B, F, T] compare-and-sum;
``torch.searchsorted(cum, pos, right=True)`` is the same count without the
temporary. Frames past sum(d) clamp to the last token (callers mask them).
"""
from __future__ import annotations

import torch


def frame_token_indices(durations: torch.Tensor,
                        num_frames: int) -> torch.Tensor:
    """durations [B, T] (int frames per token) -> token index per frame
    [B, F]."""
    cum = torch.cumsum(durations, dim=-1).contiguous()
    pos = torch.arange(num_frames, dtype=cum.dtype, device=cum.device)
    pos = pos[None, :].expand(cum.shape[0], num_frames).contiguous()
    idx = torch.searchsorted(cum, pos, right=True)
    return idx.clamp(max=durations.shape[-1] - 1)


def expand_by_duration(features: torch.Tensor, durations: torch.Tensor,
                       num_frames: int) -> torch.Tensor:
    """Gather token features to frames: [B, T, C] x [B, T] -> [B, F, C]."""
    idx = frame_token_indices(durations, num_frames)
    return torch.gather(
        features, 1, idx[..., None].expand(-1, -1, features.shape[-1]))


def frame_mask(durations: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[B, T] -> [B, F] float validity mask (1 for frames < sum(d))."""
    total = durations.sum(dim=-1, keepdim=True)
    pos = torch.arange(num_frames, dtype=total.dtype,
                       device=total.device)[None, :]
    return (pos < total).to(torch.float32)
