# -*- coding: utf-8 -*-
"""Token type shared across G2P stages
(capability parity with reference src/illufly_tts/core/g2p/token.py:5-18)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class MToken:
    text: str
    tag: str = ""
    whitespace: str = ""
    phonemes: Optional[str] = None
    start_ts: Optional[float] = None
    end_ts: Optional[float] = None
    extras: Dict[str, Any] = field(default_factory=dict)
