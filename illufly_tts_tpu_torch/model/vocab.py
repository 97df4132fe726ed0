# -*- coding: utf-8 -*-
"""Phoneme vocabulary (PyTorch port).

Counterpart of ``illufly_tts_tpu/model/vocab.py``. The vocabulary is built
from the symbols the text frontend can emit (zh IPA + arrow tones, en IPA +
stress marks, punctuation); the port keeps its own copy of the zh IPA tables
it is built from, so it depends on nothing outside this package.

id 0 is PAD and doubles as BOS/EOS.
"""
from __future__ import annotations

from typing import Dict, List

# pinyin initial/final -> IPA (standard Mandarin tables; copy of the
# frontend's tables, which only contribute their glyph inventory here)
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

# every IPA glyph the zh side can emit (arrow tones included)
ZH_IPA_CHARS = sorted(
    set("".join(INITIAL_IPA.values()) + "".join(FINAL_IPA.values()))
    | set("→↗↓↘ɚ")
)

_EN_IPA = list("ɑæʌɔaʊɪieɛɝəɚoʃʒθðŋɹbdfɡhjklmnpstuvwzˈˌː")
# GB English additions: LOT vowel + bare NURSE vowel
_EN_GB = ["ɒ", "ɜ"]
# digraphs enter the vocab per character
_EN_EXTRA = ["dʒ", "tʃ", "eɪ", "aɪ", "ɔɪ", "oʊ", "aʊ"]
_PUNCT = list(';:,.!?—…"()“”/ \'-')
_MISC = list("❓$&@#%+=*~^|<>[]{} ")

PAD_ID = 0


def _build() -> Dict[str, int]:
    symbols: List[str] = ["$"]  # id 0: PAD/BOS/EOS
    seen = {"$"}
    for group in (_PUNCT, ZH_IPA_CHARS, _EN_IPA, _EN_GB, _EN_EXTRA, _MISC):
        for s in group:
            for ch in s:  # the vocab is per character
                if ch not in seen:
                    seen.add(ch)
                    symbols.append(ch)
    return {s: i for i, s in enumerate(symbols)}


VOCAB: Dict[str, int] = _build()
N_TOKEN = 256  # embedding rows (>= len(VOCAB))
assert len(VOCAB) <= N_TOKEN, len(VOCAB)


def encode(phonemes: str, max_len: int | None = None) -> List[int]:
    """Phoneme string -> [0] + ids + [0], dropping unknown chars."""
    ids = [VOCAB[c] for c in phonemes if c in VOCAB]
    if max_len is not None and len(ids) > max_len - 2:
        ids = ids[: max_len - 2]
    return [PAD_ID] + ids + [PAD_ID]
