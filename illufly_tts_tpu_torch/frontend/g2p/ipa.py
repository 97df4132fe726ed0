# -*- coding: utf-8 -*-
"""Pinyin -> IPA (with Misaki-style arrow tones).

Standard Mandarin phonology tables (Duanmu/Lin conventions, same sources the
reference's transcription.py cites — src/illufly_tts/core/g2p/transcription.py:18-284),
with the reference's retone convention (chinese_g2p.py:47-56):
tone1 '→', tone2 '↗', tone3 '↓', tone4 '↘', neutral unmarked; syllabic i 'ɨ'.
"""
from __future__ import annotations

from typing import Dict

INITIAL_IPA: Dict[str, str] = {
    "b": "p", "p": "pʰ", "m": "m", "f": "f",
    "d": "t", "t": "tʰ", "n": "n", "l": "l",
    "g": "k", "k": "kʰ", "h": "x",
    "j": "tɕ", "q": "tɕʰ", "x": "ɕ",
    "zh": "ʈʂ", "ch": "ʈʂʰ", "sh": "ʂ", "r": "ʐ",
    "z": "ts", "c": "tsʰ", "s": "s",
    "": "",
}

FINAL_IPA: Dict[str, str] = {
    "a": "a", "o": "o", "e": "ɤ", "ê": "e",
    "ai": "ai", "ei": "ei", "ao": "au", "ou": "ou",
    "an": "an", "en": "ən", "ang": "aŋ", "eng": "əŋ", "er": "ɚ",
    "i": "i", "u": "u", "v": "y",
    "ii": "ɨ", "iii": "ɨ",
    "ia": "ja", "io": "jo", "ie": "je", "iao": "jau", "iou": "jou",
    "ian": "jɛn", "in": "in", "iang": "jaŋ", "ing": "iŋ", "iong": "jʊŋ",
    "ua": "wa", "uo": "wo", "uai": "wai", "uei": "wei",
    "uan": "wan", "uen": "wən", "uang": "waŋ", "ueng": "wəŋ",
    "ong": "ʊŋ",
    "ve": "ɥe", "van": "ɥɛn", "vn": "yn",
    "n": "n", "ng": "ŋ", "m": "m",
}

TONE_IPA: Dict[str, str] = {"1": "→", "2": "↗", "3": "↓", "4": "↘", "5": ""}

# Every IPA glyph the zh side can emit (used to build the model vocab).
ZH_IPA_CHARS = sorted(
    set("".join(INITIAL_IPA.values()) + "".join(FINAL_IPA.values()))
    | set("→↗↓↘ɚ")
)


def syllable_to_ipa(initial: str, final_with_tone: str) -> str:
    """('l', 'iou2') -> 'ljou↗'; erhua R adds 'ɚ'."""
    tone = "5"
    final = final_with_tone
    if final and final[-1].isdigit():
        tone = final[-1]
        final = final[:-1]
    erhua = ""
    if final.endswith("R"):
        final = final[:-1]
        erhua = "ɚ"
    ipa_initial = INITIAL_IPA.get(initial, "")
    ipa_final = FINAL_IPA.get(final, "")
    if not ipa_final and not ipa_initial:
        return ""
    return ipa_initial + ipa_final + erhua + TONE_IPA.get(tone, "")
