# -*- coding: utf-8 -*-
"""Tiny .env loader (the reference uses python-dotenv, which is not in this
environment; reference: src/illufly_tts/__main__.py:13-14)."""
from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def load_dotenv(path: str = ".env", override: bool = False) -> int:
    """Load KEY=VALUE lines into os.environ. Returns count loaded."""
    if not os.path.exists(path):
        return 0
    count = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip().strip("'\"")
            if override or key not in os.environ:
                os.environ[key] = value
                count += 1
    if count:
        logger.info("loaded %d vars from %s", count, path)
    return count
