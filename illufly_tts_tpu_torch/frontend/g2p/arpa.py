# -*- coding: utf-8 -*-
"""ARPAbet -> IPA conversion.

Role of the reference's ``TTSPipeline.arpa_to_ipa`` (reference
core/pipeline.py:515-550) and the EnglishG2P ARPA fallback map
(english_g2p.py:600-631). Improvement over the reference: CMU stress
digits (AH0/AH1/AH2) are handled — digit 1 places a primary and 2 a
secondary stress mark before the syllable's vowel; the reference's map
has no digit entries at all, so real CMU dictionary lines fall through
unmapped there.
"""
from __future__ import annotations

ARPA_TO_IPA = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ",
    "AY": "aɪ", "B": "b", "CH": "tʃ", "D": "d", "DH": "ð",
    "EH": "ɛ", "ER": "ɝ", "EY": "eɪ", "F": "f", "G": "ɡ",
    "HH": "h", "IH": "ɪ", "IY": "i", "JH": "dʒ", "K": "k",
    "L": "l", "M": "m", "N": "n", "NG": "ŋ", "OW": "oʊ",
    "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v",
    "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}
# unstressed AH reduces to schwa in every CMU-derived lexicon
_REDUCED = {"AH0": "ə", "ER0": "ɚ"}
_STRESS = {"1": "ˈ", "2": "ˌ"}


def is_arpa(pron: str) -> bool:
    """True when every space-separated token is an ARPAbet phone
    (with optional stress digit) — used to auto-detect CMU-style
    dictionary lines."""
    tokens = pron.split()
    if not tokens:
        return False
    for tok in tokens:
        base = tok[:-1] if tok[-1:] in "012" else tok
        if base.upper() not in ARPA_TO_IPA:
            return False
    return True


def arpa_to_ipa(arpa_phonemes: str) -> str:
    """Convert an ARPAbet phone sequence to IPA.

    Stress digits become IPA stress marks placed before the carrying
    vowel; unknown tokens pass through unchanged (reference behavior,
    pipeline.py:544-547)."""
    out = []
    for tok in arpa_phonemes.split():
        stress = ""
        base = tok
        if tok[-1:] in "012":
            base = tok[:-1]
            stress = _STRESS.get(tok[-1], "")
        ipa = _REDUCED.get(tok.upper()) or ARPA_TO_IPA.get(base.upper())
        if ipa is None:
            out.append(tok)  # pass through unknown tokens
        else:
            out.append(stress + ipa)
    return "".join(out)
