"""The benchmark's text: frozen frontend tables, the G2P that stands in for
the program's (whose Chinese side needs ``jieba``, absent on the card's
host), and the composition of unique texts from a seed.

Texts are composed from pieces whose normalized form is known: Chinese
words and English words (each its own normalized form) and clauses with a
number, a date, money, a temperature or a percentage (normalized by the
live frontend when the tables were built, ``perfbench/data/``). So every
text comes with the normalized text the program's normalizers must make of
it, and with the IPA the pipeline must hand the engine: the stand-in G2P's
spelling of that normalized text, cut to the engine's 510 phonemes."""
from __future__ import annotations

import os
import re
from typing import Tuple

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
MAX_PHONEMES = 510
PUNCT_IPA = {"，": ",", "。": ".", ",": ",", ".": ".", " ": " "}
_TOKEN = re.compile(r"[一-鿿]|[a-z]+|.", re.S)


def load_tables() -> dict:
    def rows(name):
        with open(os.path.join(DATA, name), encoding="utf-8") as f:
            return [line.rstrip("\n").split("\t") for line in f if line.strip()]

    numbers = rows("numbers.tsv")
    return {
        "zh_chars": dict(rows("zh_chars.tsv")),
        "zh_words": [r[0] for r in rows("zh_words.txt")],
        "en_words": dict(rows("en_words.tsv")),
        "en_list": [r[0] for r in rows("en_words.tsv")],
        "numbers": {lang: [(raw, norm) for l2, raw, norm in numbers
                           if l2 == lang] for lang in ("zh", "en")},
    }


def spell(normalized: str, tables: dict) -> str:
    """The stand-in G2P: each Chinese character's IPA as the live G2P gives
    it for the character alone, each English word's as it gives it for the
    word alone, punctuation as it writes it. A character outside the tables
    raises KeyError."""
    out = []
    for tok in _TOKEN.findall(normalized):
        if "一" <= tok[0] <= "鿿":
            out.append(tables["zh_chars"][tok])
        elif tok[0].isascii() and tok[0].isalpha():
            out.append(tables["en_words"][tok])
        else:
            out.append(PUNCT_IPA[tok])
    return "".join(out)


def expected_ipa(normalized: str, tables: dict) -> str:
    return spell(normalized, tables)[:MAX_PHONEMES]


class FrozenG2P:
    """The G2P interface the pipeline calls (``text_to_phonemes``,
    ``convert_to_ipa``), answered from the frozen tables."""

    def __init__(self, tables: dict):
        self.tables = tables

    def text_to_phonemes(self, text: str) -> str:
        return spell(text, self.tables)

    def convert_to_ipa(self, phonemes: str) -> str:
        return phonemes


# ---- composition -------------------------------------------------------------


def _zh_clause(rng, tables, en_words: int = 0) -> Tuple[str, str]:
    words = [tables["zh_words"][i] for i in
             rng.integers(0, len(tables["zh_words"]), rng.integers(2, 5))]
    raw, norm = list(words), list(words)
    if en_words:
        # an English word between two Chinese ones: the normalizer puts a
        # space before it
        en = tables["en_list"]
        words.insert(1, en[rng.integers(0, len(en))])
        raw = words
        norm = [w if i != 1 else " " + w for i, w in enumerate(words)]
    return "".join(raw), "".join(norm)


def _en_clause(rng, tables) -> Tuple[str, str]:
    en = tables["en_list"]
    words = [en[i] for i in rng.integers(0, len(en), rng.integers(3, 9))]
    text = " ".join(words)
    return text, text


def _clauses(rng, lang: str, tables: dict, number_share: float):
    """Endless (raw, normalized) clauses of a text in ``lang`` ("zh",
    "mixed" or "en"): a number clause among the first three at probability
    ``number_share``, one or two English words among the clauses of a mixed
    text."""
    number_at = int(rng.integers(0, 3)) if rng.random() < number_share else -1
    mixed_left = int(rng.integers(1, 3)) if lang == "mixed" else 0
    k = 0
    while True:
        if k == number_at:
            pool = tables["numbers"]["en" if lang == "en" else "zh"]
            yield pool[rng.integers(0, len(pool))]
        elif lang == "en":
            yield _en_clause(rng, tables)
        else:
            take = 1 if mixed_left and rng.random() < 0.6 else 0
            mixed_left -= take
            yield _zh_clause(rng, tables, take)
        k += 1


def _join(lang: str, parts) -> Tuple[str, str]:
    sep, end = ("，", "。") if lang != "en" else (", ", ".")
    return (sep.join(r for r, _ in parts) + end,
            sep.join(n for _, n in parts) + end)


def compose(rng, lang: str, target: int, tables: dict,
            number_share: float) -> Tuple[str, str]:
    """A text of about ``target`` characters in ``lang``, clauses added
    until it reaches the target. -> (raw text, its normalized text)."""
    parts, length = [], 0
    for raw, norm in _clauses(rng, lang, tables, number_share):
        parts.append((raw, norm))
        length += len(raw) + (2 if lang == "en" else 1)
        if length >= target:
            return _join(lang, parts)


def compose_tokens(rng, lang: str, target: int, tables: dict,
                   number_share: float, most: int):
    """A text whose ids (IPA characters and the two ends) number about
    ``target`` and at most ``most``: clauses added until it reaches the
    target, or until one more would pass ``most``. (None, None) where the
    first clause already does."""
    sep_ipa = 1 if lang != "en" else 2
    parts, n = [], 3  # the two ends and the closing stop
    for raw, norm in _clauses(rng, lang, tables, number_share):
        grown = n + len(spell(norm, tables)) + (sep_ipa if parts else 0)
        if grown > most:
            return _join(lang, parts) if parts else (None, None)
        parts.append((raw, norm))
        n = grown
        if n >= target:
            return _join(lang, parts)
