# -*- coding: utf-8 -*-
"""Static shape buckets (PyTorch port of ``illufly_tts_tpu/engine/buckets.py``).

The port runs eagerly, so buckets no longer bound a compile inventory; they
still decide the padded shapes, and the frame bucket decides how durations
are fitted (``_fit_durations``), so they are part of the numerics."""
from __future__ import annotations

from typing import Sequence

TOKEN_BUCKETS: Sequence[int] = (16, 32, 64, 128, 256, 512)
FRAME_BUCKETS: Sequence[int] = (
    64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
)
BATCH_BUCKETS: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)


def pick(buckets: Sequence[int], needed: int) -> int:
    for b in buckets:
        if needed <= b:
            return b
    return buckets[-1]
