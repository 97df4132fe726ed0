# -*- coding: utf-8 -*-
"""Chinese G2P orchestrator: text -> zhuyin phonemes -> IPA.

Capability parity with the reference's ``ChineseG2P``
(reference: src/illufly_tts/core/g2p/chinese_g2p.py:24-258): numeral
pre-pass, CJK punctuation mapping, zh/en run splitting with an English
callback, zhuyin phoneme output, and IPA conversion with arrow tones.

Design note: the reference's ``convert_to_ipa`` re-pinyinizes only the hanzi
stand-ins inside its zhuyin string (chinese_g2p.py:85-95), leaving raw zhuyin
glyphs untouched. Here the zhuyin encoding is losslessly invertible, so IPA
conversion covers the full sequence deterministically.
"""
from __future__ import annotations

import re
from typing import Optional, Set

from .ipa import syllable_to_ipa
from .numcvt import an2cn
from .zh_frontend import ZHFrontend
from .zhuyin import ZHUYIN_CHARS, zhuyin_syllable_to_pinyin

_PUNCT_MAP = [
    ("、", ", "), ("，", ", "), ("。", ". "), ("．", ". "),
    ("！", "! "), ("：", ": "), ("；", "; "), ("？", "? "),
    ("«", ' "'), ("»", '" '), ("《", ' "'), ("》", '" '),
    ("「", ' "'), ("」", '" '), ("【", ' "'), ("】", '" '),
    ("（", " ("), ("）", ") "), ("‘", "'"), ("’", "'"),
    ("“", '"'), ("”", '"'),
]

_RE_EN_RUN = re.compile(r"([A-Za-z \'-]*[A-Za-z][A-Za-z \'-]*)|([^A-Za-z]+)")
_RE_ZHUYIN_SYLLABLE = re.compile(
    "([" + "".join(sorted(ZHUYIN_CHARS)) + "]+[1-5]?)"
)


# zhuyin chunk -> IPA memo (see _zhuyin_chunk_to_ipa)
_ZY_CACHE: dict = {}


class ChineseG2P:
    def __init__(self, unk: str = "❓", en_callable=None):
        self.unk = unk
        self.en_callable = en_callable
        self.frontend = ZHFrontend(unk=unk)

    @staticmethod
    def map_punctuation(text: str) -> str:
        for old, new in _PUNCT_MAP:
            text = text.replace(old, new)
        return text.strip()

    def text_to_phonemes(self, text: str) -> str:
        """Text -> zhuyin phoneme string ('/' separates words)."""
        if not text.strip():
            return ""
        text = an2cn(text)
        text = self.map_punctuation(text)
        segments = []
        for en, zh in _RE_EN_RUN.findall(text):
            en, zh = en.strip(), zh.strip()
            if zh:
                result, _ = self.frontend(zh)
                segments.append(result)
            elif en:
                if self.en_callable is None:
                    segments.append(self.unk)
                else:
                    segments.append(self.en_callable(en))
        return " ".join(segments)

    def convert_to_ipa(self, phonemes: str) -> str:
        """Zhuyin phoneme string -> IPA with arrow tones."""
        result = self._convert_runs(phonemes).replace("/", " ")
        return re.sub(r"\s{2,}", " ", result).strip()

    def _convert_runs(self, phonemes: str) -> str:
        """Zhuyin->IPA without the word-separator/whitespace cleanup
        (shared by ``convert_to_ipa`` and ``text_to_ipa_words``)."""
        out = []
        pos = 0
        for match in _RE_ZHUYIN_SYLLABLE.finditer(phonemes):
            if match.start() > pos:
                out.append(phonemes[pos:match.start()])
            chunk = match.group(0)
            # A chunk may contain several zhuyin syllables back-to-back if
            # tones are missing; parse greedily syllable-by-syllable.
            ipa = self._zhuyin_chunk_to_ipa(chunk)
            out.append(ipa)
            pos = match.end()
        if pos < len(phonemes):
            out.append(phonemes[pos:])
        return "".join(out)

    def text_to_ipa_words(self, text: str):
        """Per-word IPA: [(surface_word, word_ipa)] in utterance order,
        where ``word_ipa`` is the word's slice of ``text_to_ipa(text)``
        (same zhuyin->IPA conversion applied token-locally — word
        boundaries are '/' separators, which the syllable regex never
        crosses). Surface words are post-an2cn (numbers verbalized), the
        jieba segmentation the frontend renders; English segments pair
        word-by-word when the G2P keeps a 1:1 space alignment, else the
        whole segment becomes one entry. Basis for word-level timestamps
        (beyond-reference: the reference's MToken start_ts/end_ts fields
        are never populated, english_g2p.py:640,698)."""
        if not text.strip():
            return []
        text = an2cn(text)
        text = self.map_punctuation(text)
        entries = []
        for en, zh in _RE_EN_RUN.findall(text):
            en, zh = en.strip(), zh.strip()
            if zh:
                _, tokens = self.frontend(zh)
                for tk in tokens:
                    zy = tk.phonemes if tk.phonemes is not None else self.unk
                    ipa = self._convert_runs(zy).replace("/", " ").strip()
                    if ipa:
                        entries.append((tk.text, ipa))
            elif en:
                if self.en_callable is None:
                    entries.append((en, self.unk))
                    continue
                seg_ipa = self.en_callable(en).strip()
                words = en.split()
                parts = seg_ipa.split()
                if len(words) == len(parts):
                    entries.extend(zip(words, parts))
                elif seg_ipa:
                    entries.append((en, seg_ipa))
        return entries

    def _zhuyin_chunk_to_ipa(self, chunk: str) -> str:
        # pure str->str over static tables: memoize (syllable chunks come
        # from a small closed inventory, so this is a near-total hit rate)
        hit = _ZY_CACHE.get(chunk)
        if hit is not None:
            return hit
        out = self._zhuyin_chunk_to_ipa_uncached(chunk)
        if len(_ZY_CACHE) < 50_000:
            _ZY_CACHE[chunk] = out
        return out

    def _zhuyin_chunk_to_ipa_uncached(self, chunk: str) -> str:
        # Split on tone digits: each syllable ends with its tone.
        parts = re.findall(r"[^1-5]+[1-5]?", chunk)
        out = []
        for part in parts:
            parsed = zhuyin_syllable_to_pinyin(part)
            if parsed is None:
                out.append(part)
                continue
            initial, final = parsed
            ipa = syllable_to_ipa(initial, final)
            out.append(ipa if ipa else part)
        return "".join(out)

    def text_to_ipa(self, text: str) -> str:
        return self.convert_to_ipa(self.text_to_phonemes(text))

    def get_phoneme_set(self) -> Set[str]:
        from .zhuyin import ZHUYIN_CHARS as chars

        return set(chars) | set("12345R/ ") | set(';:,.!?—…"()')

    def get_language(self) -> str:
        return "zh"
