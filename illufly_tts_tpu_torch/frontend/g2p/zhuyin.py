# -*- coding: utf-8 -*-
"""Pinyin (strict initial/final) <-> zhuyin (bopomofo) conversion.

Standard bopomofo correspondence (the reference instead maps compound finals
to single stand-in hanzi, src/illufly_tts/core/g2p/zh_frontend.py:39; we use
real multi-glyph zhuyin, which keeps the intermediate representation
standard and losslessly invertible)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

INITIAL_TO_ZHUYIN: Dict[str, str] = {
    "b": "ㄅ", "p": "ㄆ", "m": "ㄇ", "f": "ㄈ",
    "d": "ㄉ", "t": "ㄊ", "n": "ㄋ", "l": "ㄌ",
    "g": "ㄍ", "k": "ㄎ", "h": "ㄏ",
    "j": "ㄐ", "q": "ㄑ", "x": "ㄒ",
    "zh": "ㄓ", "ch": "ㄔ", "sh": "ㄕ", "r": "ㄖ",
    "z": "ㄗ", "c": "ㄘ", "s": "ㄙ",
}

FINAL_TO_ZHUYIN: Dict[str, str] = {
    "a": "ㄚ", "o": "ㄛ", "e": "ㄜ", "ê": "ㄝ",
    "ai": "ㄞ", "ei": "ㄟ", "ao": "ㄠ", "ou": "ㄡ",
    "an": "ㄢ", "en": "ㄣ", "ang": "ㄤ", "eng": "ㄥ", "er": "ㄦ",
    "i": "ㄧ", "u": "ㄨ", "v": "ㄩ",
    "ii": "ㄭ", "iii": "ㄭ",  # syllabic i after z/c/s/zh/ch/sh/r
    "ia": "ㄧㄚ", "io": "ㄧㄛ", "ie": "ㄧㄝ", "iao": "ㄧㄠ",
    "iou": "ㄧㄡ", "ian": "ㄧㄢ", "in": "ㄧㄣ", "iang": "ㄧㄤ",
    "ing": "ㄧㄥ", "iong": "ㄩㄥ",
    "ua": "ㄨㄚ", "uo": "ㄨㄛ", "uai": "ㄨㄞ", "uei": "ㄨㄟ",
    "uan": "ㄨㄢ", "uen": "ㄨㄣ", "uang": "ㄨㄤ", "ueng": "ㄨㄥ",
    "ong": "ㄨㄥ",
    "ve": "ㄩㄝ", "van": "ㄩㄢ", "vn": "ㄩㄣ",
    # syllabic nasals get DEDICATED glyphs (ㄯ U+312F, ㆬ U+31AC): the
    # previous ㄣ/ㄇ reuse collided with final 'en' and initial 'm', so
    # the round trip turned 嗯 (final n2, zh_frontend.py pypinyin-compat
    # quirk) into 'en2' — breaking the invertibility this module claims
    "ng": "ㄫ", "n": "ㄯ", "m": "ㆬ",
}

ZHUYIN_TO_INITIAL = {v: k for k, v in INITIAL_TO_ZHUYIN.items()}
# Inverse final table: prefer canonical pinyin on glyph collisions.
ZHUYIN_TO_FINAL: Dict[str, str] = {}
for _py, _zy in FINAL_TO_ZHUYIN.items():
    ZHUYIN_TO_FINAL.setdefault(_zy, _py)
ZHUYIN_TO_FINAL["ㄨㄥ"] = "ong"  # with-initial reading; bare syllable -> ueng

ZHUYIN_CHARS = set("".join(INITIAL_TO_ZHUYIN.values())) | set(
    "".join(FINAL_TO_ZHUYIN.values())
)


def syllable_to_zhuyin(initial: str, final_with_tone: str) -> str:
    """('l', 'iou2') -> 'ㄌㄧㄡ2'. Erhua 'R' in the final maps to ㄦ."""
    tone = ""
    final = final_with_tone
    if final and final[-1].isdigit():
        tone = final[-1]
        final = final[:-1]
    erhua = ""
    if final.endswith("R"):
        final = final[:-1]
        erhua = "ㄦ"
    zy_initial = INITIAL_TO_ZHUYIN.get(initial, "")
    zy_final = FINAL_TO_ZHUYIN.get(final)
    if zy_final is None:
        return ""
    if final in ("ii", "iii"):
        zy_final = "ㄭ"
    return zy_initial + zy_final + erhua + tone


def zhuyin_syllable_to_pinyin(syllable: str) -> Optional[Tuple[str, str]]:
    """'ㄌㄧㄡ2' -> ('l', 'iou2'); returns None if not parseable."""
    tone = "5"
    if syllable and syllable[-1].isdigit():
        tone = syllable[-1]
        syllable = syllable[:-1]
    if not syllable:
        return None
    initial = ""
    if syllable[0] in ZHUYIN_TO_INITIAL:
        initial = ZHUYIN_TO_INITIAL[syllable[0]]
        syllable = syllable[1:]
    erhua = ""
    if len(syllable) > 1 and syllable.endswith("ㄦ"):
        erhua = "R"
        syllable = syllable[:-1]
    if not syllable:
        # bare initial used as syllabic (ㄇ for m̩ etc.) or z-series
        if initial in ("zh", "ch", "sh", "r"):
            return initial, "iii" + erhua + tone
        if initial in ("z", "c", "s"):
            return initial, "ii" + erhua + tone
        return initial, erhua + tone
    final = ZHUYIN_TO_FINAL.get(syllable)
    if final is None:
        return None
    if final == "ong" and not initial:
        final = "ueng"
    if final in ("ii", "iii"):
        final = "iii" if initial in ("zh", "ch", "sh", "r") else "ii"
    return initial, final + erhua + tone
