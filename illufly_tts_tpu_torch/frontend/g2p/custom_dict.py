# -*- coding: utf-8 -*-
"""User-supplied pronunciation dictionaries.

The reference ships hand-written zh/en dictionary files that no code loads
(reference: src/illufly_tts/core/resources/dictionaries/*.txt, SURVEY C22
"orphaned"). Here the capability is real: load zh word->pinyin overrides
into the phrase table and en word->IPA entries into the lexicon.

File formats (lines; '#' comments):
  zh:  <word> <pinyin1> <pinyin2> ...     e.g.  重庆 chong2 qing4
  en:  <word> <ipa>                       e.g.  kokoro koʊkoʊɹoʊ
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List

logger = logging.getLogger(__name__)

_ZH_ENTRY = re.compile(r"^([一-鿿]+)\s+((?:[a-zv]+[1-5]\s*)+)$")
_EN_ENTRY = re.compile(r"^([A-Za-z][A-Za-z'\-]*)\s+(\S.*?)\s*$")

# paths loaded into THIS process, in order — frontend.pool replays them in
# worker processes so pooled and serial G2P agree on user overrides
LOADED_ZH: List[str] = []
LOADED_EN: List[str] = []


def load_zh_dict(path: str) -> Dict[str, List[str]]:
    """Load zh overrides and register them in the live phrase table."""
    from .pinyin.phrases import PHRASES

    if path not in LOADED_ZH:
        LOADED_ZH.append(path)

    added: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            match = _ZH_ENTRY.match(line)
            if not match:
                logger.warning("ignoring malformed zh dict line: %r", line)
                continue
            word = match.group(1)
            readings = match.group(2).split()
            if len(readings) != len(word):
                logger.warning(
                    "zh dict entry %r: %d readings for %d chars, skipping",
                    word, len(readings), len(word),
                )
                continue
            PHRASES[word] = readings
            added[word] = readings
    if added:
        # the frontend memoizes word->pinyin lookups; new overrides must
        # invalidate them (zh_frontend.clear_frontend_caches)
        from .zh_frontend import clear_frontend_caches

        clear_frontend_caches()
    logger.info("loaded %d zh dictionary entries from %s", len(added), path)
    return added


def load_en_dict(path: str) -> Dict[str, str]:
    """Load en word->IPA entries into the live English lexicon.

    Two formats:
    - text lines ``word ipa`` (this repo's format, see module docstring)
    - misaki-format JSON (the reference's 13 MB ``us_gold.json``/silver
      lexicons, reference english_g2p.py:160-170): ``{"word": "ipa"}`` or
      ``{"word": {"DEFAULT": "ipa", "VERB": ...}}`` — reference users can
      point --en-dict straight at their gold files.
    """
    from .en_lexicon import LEXICON

    if path not in LOADED_EN:
        LOADED_EN.append(path)
    added: Dict[str, str] = {}
    if path.endswith(".json"):
        import json

        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        for word, value in data.items():
            if isinstance(value, dict):
                value = value.get("DEFAULT")
            if not isinstance(value, str) or not value:
                continue
            key = word.lower()
            # lowercase source keys win over case-variant proper nouns
            if key in added and word != key:
                continue
            LEXICON[key] = value
            added[key] = value
        logger.info(
            "loaded %d en lexicon entries from %s (misaki json)",
            len(added), path,
        )
        return added
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            match = _EN_ENTRY.match(line)
            if not match:
                logger.warning("ignoring malformed en dict line: %r", line)
                continue
            word = match.group(1).lower()
            pron = match.group(2)
            # CMU-style lines ("HELLO HH AH0 L OW1", the reference's
            # english_dict.txt format) convert to IPA transparently
            from .arpa import arpa_to_ipa, is_arpa

            if is_arpa(pron):
                pron = arpa_to_ipa(pron)
            elif " " in pron:
                logger.warning("ignoring malformed en dict line: %r", line)
                continue
            LEXICON[word] = pron
            added[word] = pron
    logger.info("loaded %d en dictionary entries from %s", len(added), path)
    return added
