# -*- coding: utf-8 -*-
"""British English (RP/SSB) pronunciation layer.

The reference ships a second full lexicon pair for GB English
(``gb_gold.json``/``gb_silver.json``, selected by ``Lexicon(british=True)``,
reference: src/illufly_tts/core/g2p/english_g2p.py:146-170) plus GB branches
in the -s/-ed/-ing stem rules (ref :307,332,335,358) and a GB phoneme
inventory (``GB_VOCAB``, ref :41).

We author ONE lexicon (US) and derive the GB reading with a systematic
US→GB accent transform + lexical exception sets, which is how the two
accents actually relate:

* rhoticity: coda /ɹ/ drops with compensatory lengthening or centring
  diphthongs (ɑɹ→ɑː, ɔɹ→ɔː, ɪɹ→ɪə, ɛɹ→ɛə, ʊɹ→ʊə, ɚ→ə, ɝ→ɜː)
* no flapping: ɾ→t
* LOT un-merger: US ɑ → ɒ, except the PALM set which keeps ɑː
* TRAP/BATH split: æ → a, except the BATH set which takes ɑː
* GOAT: oʊ → əʊ;  THOUGHT lengthens: ɔ → ɔː (but CLOTH words before
  ŋ/f/s/θ go to ɒ: "long", "off", "cross")
* FLEECE/GOOSE carry length marks (iː/uː) except the happY/thank-yOU
  weak finals
* the epenthetic inflection vowel is ɪ, not ə/ᵻ: roses → ɹˈəʊzɪz,
  waited → wˈeɪtɪd (ref :307,332)

Irreducibly lexical differences (schedule, lieutenant, tomato, clerk …)
live in ``GB_EXCEPTIONS``.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

# GB phoneme inventory parity target (reference english_g2p.py:41):
# AIQWYabdfhijklmnpstuvwzðŋɑɒɔəɛɜɡɪɹʃʊʌʒʤʧˈˌːθᵊ — we emit full IPA
# (digraphs spelled out), so the char set below is its expansion.
GB_IPA_CHARS = frozenset("abdfhijklmnpstuvwzðŋɑɒɔəɛɜɡɪɹʃʊʌʒʤʧˈˌːθeʊɔɪə")

_STRESS = "ˈˌ"
_VOWEL_START = frozenset("aeiouæɑɒɔəɚɛɝɪʊʌ")

# PALM set: US ɑ that stays ɑː in GB (everything else becomes LOT ɒ).
# Matched on the spelling stem (prefix + inflection-suffix check).
PALM_WORDS = frozenset(
    """father palm calm balm psalm alm qualm spa bra lava saga drama
    llama pajama pyjama facade sonata pasta piano mirage massage garage
    camouflage entourage collage montage sabotage taj mama bravado
    macho nacho taco khaki suave guava koala gala""".split()
)

# BATH set: US æ that becomes ɑː in GB.
BATH_WORDS = frozenset(
    """after afternoon answer ask aunt auntie bath basket blast branch
    brass broadcast can't cast caste castle chance chant clasp class
    command commander demand draft draught dance example fast flask
    france giraffe glance glass graft grant grasp grass half halve
    laugh laughter last mast master nasty overdraft pass past path
    plant plaster raft rather rasp sample shaft shan't slander staff
    task vast advance advantage avalanche banana behalf calf chaff
    craft enhance finance lance mask morale moustache photograph
    telegraph""".split()
)

_INFLECTIONS = ("", "s", "es", "ed", "ing", "er", "ers", "est", "ly",
                "ness", "ment", "ments", "ion", "ions", "ic", "al")


def _in_word_set(word: str, word_set: frozenset) -> bool:
    if word in word_set:
        return True
    for stem_len in range(len(word) - 1, 2, -1):
        stem = word[:stem_len]
        suffix = word[stem_len:]
        if stem in word_set and suffix in _INFLECTIONS:
            return True
        # e-drop inflection: dance -> dancing
        if stem + "e" in word_set and suffix in ("ing", "ed", "er", "es",
                                                 "ers", "est"):
            return True
        # consonant-doubled inflection: plan->planning (not BATH anyway)
        if (stem[-1:] == suffix[:1]
                and stem in word_set
                and word[stem_len + 1:] in _INFLECTIONS):
            return True
    return False


# Irreducibly lexical GB forms (authored; same role as entries that exist
# only in the reference's gb_gold.json). Keys are lowercase spellings.
GB_EXCEPTIONS: Dict[str, str] = {
    # GB drops the /l/ of palm-class words that US gold spells out
    "palm": "pˈɑːm",
    "calm": "kˈɑːm",
    "balm": "bˈɑːm",
    "psalm": "sˈɑːm",
    "almond": "ˈɑːmənd",
    "schedule": "ʃˈɛdjuːl",
    "schedules": "ʃˈɛdjuːlz",
    "scheduled": "ʃˈɛdjuːld",
    "scheduling": "ʃˈɛdjuːlɪŋ",
    "lieutenant": "lɛftˈɛnənt",
    "lieutenants": "lɛftˈɛnənts",
    "tomato": "təmˈɑːtəʊ",
    "tomatoes": "təmˈɑːtəʊz",
    "vitamin": "vˈɪtəmɪn",
    "vitamins": "vˈɪtəmɪnz",
    "privacy": "pɹˈɪvəsi",
    "herb": "hˈɜːb",
    "herbs": "hˈɜːbz",
    "clerk": "klˈɑːk",
    "clerks": "klˈɑːks",
    "derby": "dˈɑːbi",
    "berkeley": "bˈɑːkli",
    "leisure": "lˈɛʒə",
    "garage": "ɡˈaɹɑːʒ",
    "garages": "ɡˈaɹɑːʒɪz",
    "laboratory": "ləbˈɒɹətɹi",
    "laboratories": "ləbˈɒɹətɹiz",
    "advertisement": "ədvˈɜːtɪsmənt",
    "advertisements": "ədvˈɜːtɪsmənts",
    "controversy": "kəntɹˈɒvəsi",
    "oregano": "ˌɒɹɪɡˈɑːnəʊ",
    "yoghurt": "jˈɒɡət",
    "yogurt": "jˈɒɡət",
    "zebra": "zˈɛbɹə",
    "zebras": "zˈɛbɹəz",
    "mobile": "mˈəʊbaɪl",
    "missile": "mˈɪsaɪl",
    "missiles": "mˈɪsaɪlz",
    "fragile": "fɹˈadʒaɪl",
    "fertile": "fˈɜːtaɪl",
    "hostile": "hˈɒstaɪl",
    "futile": "fjˈuːtaɪl",
    "agile": "ˈadʒaɪl",
    "docile": "dˈəʊsaɪl",
    "premature": "pɹˈɛmətʃə",
    "figure": "fˈɪɡə",
    "figures": "fˈɪɡəz",
    "z": "zˈɛd",
    "dynasty": "dˈɪnəsti",
    "vase": "vˈɑːz",
    "vases": "vˈɑːzɪz",
    "ate": "ˈɛt",
    "been": "bˈiːn",
    "process": "pɹˈəʊsɛs",
    "processes": "pɹˈəʊsɛsɪz",
    "progress": "pɹˈəʊɡɹɛs",
    "route": "ɹˈuːt",
    "routes": "ɹˈuːts",
    "router": "ɹˈuːtə",
    "routers": "ɹˈuːtəz",
}

# coda-ɹ merges (applied when the ɹ is NOT prevocalic)
_CODA_R = [
    ("ɑɹ", "ɑː"), ("ɔɹ", "ɔː"), ("ɪɹ", "ɪə"), ("ɛɹ", "ɛə"),
    ("ʊɹ", "ʊə"), ("əɹ", "ə"), ("iɹ", "ɪə"), ("uɹ", "ʊə"),
]


def _drop_coda_r(ipa: str) -> str:
    """Non-rhotic transform: remove /ɹ/ unless a vowel follows (stress
    marks are transparent — 'kəɹˈɛkt' keeps its prevocalic ɹ)."""
    out = []
    i, n = 0, len(ipa)
    while i < n:
        # find an ɹ at or after i that closes a vowel
        ch = ipa[i]
        if ch != "ɹ":
            out.append(ch)
            i += 1
            continue
        # lookahead past stress marks for the next sound
        j = i + 1
        while j < n and ipa[j] in _STRESS:
            j += 1
        prevocalic = j < n and ipa[j] in _VOWEL_START
        if prevocalic:
            out.append(ch)
            i += 1
            continue
        # merge with the preceding vowel
        prev = "".join(out)
        for pat, rep in _CODA_R:
            if prev.endswith(pat[:-1]):
                out = list(prev[: len(prev) - len(pat) + 1] + rep)
                break
        else:
            if prev and prev[-1] == "ː":
                pass  # already lengthened (ɜː from ɝ)
            elif prev and prev[-1] in _VOWEL_START:
                out.append("ː")
        i += 1
    return "".join(out)


def us_to_gb(ipa: str, word: str = "") -> str:
    """Systematic US→GB IPA transform (see module docstring).

    ``word`` (lowercase spelling) keys the lexical BATH/PALM/CLOTH
    decisions; pass "" to apply the default mappings only.
    """
    if not ipa:
        return ipa
    # 1. no flapping
    ipa = ipa.replace("ɾ", "t")
    # 2. r-colored vowels; prevocalic ones keep a linking ɹ
    #    ("answering" ˈænsɚɪŋ → ˈɑːnsəɹɪŋ, "stirring" stɝɪŋ → stɜːɹɪŋ)
    ipa = re.sub(r"ɝ(?=[ˈˌ]?[aeiouæɑɒɔəɛɪʊʌ])", "ɜːɹ", ipa)
    ipa = re.sub(r"ɚ(?=[ˈˌ]?[aeiouæɑɒɔəɛɪʊʌ])", "əɹ", ipa)
    ipa = ipa.replace("ɝ", "ɜː").replace("ɚ", "ə")
    # 3. non-rhotic coda
    ipa = _drop_coda_r(ipa)
    # 4. GOAT (before LOT so the əʊ's ʊ is never touched)
    ipa = ipa.replace("oʊ", "əʊ")
    # 5. LOT / PALM
    if "ɑ" in ipa:
        palm = _in_word_set(word, PALM_WORDS)
        ipa = re.sub(r"ɑ(?!ː)", "ɑː" if palm else "ɒ", ipa)
    # 6. TRAP / BATH — in BATH words only the last æ is the BATH vowel
    #    ("advantage" ædvˈæntədʒ → ədvˈɑːntɪdʒ keeps its weak prefix)
    if "æ" in ipa:
        if _in_word_set(word, BATH_WORDS):
            k = ipa.rfind("æ")
            ipa = ipa[:k] + "ɑː" + ipa[k + 1:]
        ipa = ipa.replace("æ", "a")
    # 7. THOUGHT lengthens; CLOTH shortens to ɒ before ŋ f s θ ɡ
    ipa = re.sub(r"ɔ(?![ːɪ])([ŋfsθɡ])", r"ɒ\1", ipa)
    ipa = re.sub(r"ɔ(?![ːɪ])", "ɔː", ipa)
    # 8. FLEECE / GOOSE length (weak word-final i/u stay short: happY)
    ipa = re.sub(r"i(?![ː])(?!$)", "iː", ipa)
    ipa = re.sub(r"u(?![ː])(?!$)", "uː", ipa)
    if ipa.endswith(("ˈi", "ˌi", "ˈu", "ˌu")):
        # stressed word-final FLEECE/GOOSE is long ("see", "few"); weak
        # finals (happY, the) keep the short vowel
        ipa += "ː"
    elif (ipa.endswith(("i", "u")) and word != "the"
          and sum(c in _VOWEL_START for c in ipa) == 1):
        # monosyllables carry citation length ("see" si → siː, "do" duː);
        # prevocalic weak "the" (ði) stays short
        ipa += "ː"
    # 9. epenthetic inflection vowel is ɪ (ref english_g2p.py:307,332)
    ipa = re.sub(r"(s|z|ʃ|ʒ|tʃ|dʒ)əz$", r"\1ɪz", ipa)
    ipa = re.sub(r"([td])əd$", r"\1ɪd", ipa)
    return ipa


def gb_word(word_lower: str) -> Optional[str]:
    """Exception-table lookup (GB forms not derivable from the US entry)."""
    return GB_EXCEPTIONS.get(word_lower)
