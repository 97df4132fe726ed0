# -*- coding: utf-8 -*-
"""Pinyin engine: hanzi -> pinyin and pinyin -> strict initial/final.

Replaces the external ``pypinyin`` used by the reference
(reference: src/illufly_tts/core/g2p/zh_frontend.py:90-116). Provides:

- ``word_pinyin(word)``       phrase-aware readings with tone digits
- ``split_initial_final(py)`` strict-mode initial/final split matching
  pypinyin's ``Style.INITIALS`` / ``Style.FINALS_TONE3`` semantics
  (y/w are not initials; iu/ui/un expand to iou/uei/uen; jqx + u -> v).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .data import PINYIN_SUPPLEMENT, PINYIN_TABLE
from .phrases import DEFAULTS, PHRASES

_CJK = re.compile(r"[㐀-鿿]")
_ANNOT = re.compile(r".\([^)]*\)")  # "X(...)": X belongs to another syllable

_INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k",
    "h", "j", "q", "x", "r", "z", "c", "s",
]

# y-/w- onset syllables -> strict finals.
_Y_FINALS = {
    "yi": "i", "ya": "ia", "ye": "ie", "yao": "iao", "you": "iou",
    "yan": "ian", "yin": "in", "yang": "iang", "ying": "ing",
    "yong": "iong", "yu": "v", "yue": "ve", "yuan": "van", "yun": "vn",
    "yo": "io",
}
_W_FINALS = {
    "wu": "u", "wa": "ua", "wo": "uo", "wai": "uai", "wei": "uei",
    "wan": "uan", "wen": "uen", "wang": "uang", "weng": "ueng",
}
# Abbreviated finals -> strict full finals (after a consonant initial).
_EXPAND = {"iu": "iou", "ui": "uei", "un": "uen"}


def _build_tables() -> Tuple[Dict[str, List[str]], Dict[str, str]]:
    readings: Dict[str, List[str]] = {}
    table = PINYIN_TABLE + "\n" + PINYIN_SUPPLEMENT
    for line in table.strip().splitlines():
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        syllable, chars = parts
        if not re.fullmatch(r"[a-zv]+[1-5]", syllable):
            continue
        chars = _ANNOT.sub("", chars)
        for ch in chars:
            if not _CJK.match(ch):
                continue
            readings.setdefault(ch, [])
            if syllable not in readings[ch]:
                readings[ch].append(syllable)
    defaults = {ch: rs[0] for ch, rs in readings.items()}
    for ch, py in DEFAULTS.items():
        if ch in readings and py not in readings[ch]:
            readings[ch].append(py)
        readings.setdefault(ch, [py])
        defaults[ch] = py
    return readings, defaults


CHAR_READINGS, CHAR_DEFAULT = _build_tables()


def char_pinyin(ch: str) -> Optional[str]:
    return CHAR_DEFAULT.get(ch)


def word_pinyin(word: str) -> List[Optional[str]]:
    """Readings for a word: phrase table first, then per-char defaults."""
    if word in PHRASES:
        return list(PHRASES[word])
    result: List[Optional[str]] = []
    i = 0
    n = len(word)
    while i < n:
        # Greedy longest sub-phrase match inside the word (handles jieba
        # segmenting e.g. 银行卡 as one token).
        matched = False
        for j in range(min(n, i + 4), i + 1, -1):
            sub = word[i:j]
            if sub in PHRASES:
                result.extend(PHRASES[sub])
                i = j
                matched = True
                break
        if not matched:
            result.append(CHAR_DEFAULT.get(word[i]))
            i += 1
    return result


def text_pinyin(text: str) -> List[Optional[str]]:
    """Per-character readings for arbitrary text (no segmentation)."""
    return word_pinyin(text)


def split_initial_final(pinyin: str) -> Tuple[str, str]:
    """Split 'liu2' -> ('l', 'iou2'), 'yan2' -> ('', 'ian2'), strict mode."""
    match = re.fullmatch(r"([a-zv]+)([1-5]?)", pinyin)
    if not match:
        return "", pinyin
    body, tone = match.group(1), match.group(2) or "5"

    if body in ("n", "ng", "m", "hm", "hng"):  # syllabic nasals (嗯 etc.)
        return "", body + tone

    if body.startswith("y"):
        final = _Y_FINALS.get(body)
        if final is None:
            final = "i" + body[1:] if body[1] not in "aeiouv" else body[1:]
        return "", final + tone
    if body.startswith("w"):
        final = _W_FINALS.get(body, "u" + body[1:])
        return "", final + tone

    initial = ""
    for cand in _INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    final = body[len(initial):]

    if initial in ("j", "q", "x"):
        # ju -> v, juan -> van, jun -> vn, jue -> ve
        if final.startswith("u"):
            final = "v" + final[1:]
    elif initial in ("n", "l") and final.startswith("ue"):
        # ASCII 'lue'/'nue' spell lüe/nüe: the final is ve (ü), not ue
        final = "v" + final[1:]
    if final in _EXPAND:
        final = _EXPAND[final]
    if final == "u:" or final == "ü":
        final = "v"
    return initial, final + tone
