# -*- coding: utf-8 -*-
"""English pronunciation lexicon (US), loaded from data files.

The reference ships ~12.6 MB third-party gold/silver JSON lexicons adapted
from Misaki (reference: src/illufly_tts/core/g2p/english_g2p.py:160-170,
data/us_gold.json). Those are deliberately not copied; instead:

- ``data/en_core.tsv``    — hand-authored high-frequency words, irregular
  spellings, proper nouns (word<TAB>IPA; ˈ/ˌ stress before the vowel)
- ``data/en_derived.tsv`` — regular morphological expansions generated by
  ``scripts/build_en_lexicon.py`` (loaded first so hand entries win)
- users can bring the reference's misaki-format JSON lexicons at runtime
  via ``--en-dict`` (custom_dict.load_en_dict)

``en_g2p.py`` adds stem rules and stress-aware letter-to-sound for OOV.
"""
from __future__ import annotations

import os
from typing import Dict

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load(path: str, table: Dict[str, str]) -> None:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            word, _, ipa = line.partition("\t")
            if ipa:
                # keys are lowercased: lookup is case-insensitive
                # (proper nouns are written capitalized in the TSV)
                table[word.lower()] = ipa


def _build() -> Dict[str, str]:
    table: Dict[str, str] = {}
    derived = os.path.join(_DATA_DIR, "en_derived.tsv")
    if os.path.exists(derived):
        _load(derived, table)
    _load(os.path.join(_DATA_DIR, "en_core.tsv"), table)  # hand entries win
    return table


LEXICON: Dict[str, str] = _build()
