"""Build the frozen frontend tables of ``perfbench/data/`` with the live
text frontend (it needs ``jieba``, so run it where that imports):

    python3 perfbench/data/build_tables.py

Writes:
- ``zh_words.txt``: common Chinese words (``jieba``'s dictionary, by
  frequency), each its own normalized text;
- ``zh_chars.tsv``: character, its IPA from the live G2P on the character
  alone, for every character of the words and of the number clauses;
- ``en_words.tsv``: common English words (the frontend's frequency list),
  each its own normalized text, and their IPA from the live G2P;
- ``numbers.tsv``: language, a clause with a number, a date, money, a
  temperature or a percentage, and its normalized text from the live
  normalizers.

``perfbench/tests/test_perfbench_frontend.py`` holds the tables to the live
frontend."""
from __future__ import annotations

import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
HANZI = re.compile(r"^[一-鿿]+$")
ZH_WORDS = 1500
EN_WORDS = 1100
MONTHS = ("January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December")


def live_frontend():
    sys.path.insert(0, ROOT)
    from illufly_tts_tpu_torch.pipeline import TTSPipeline

    live = TTSPipeline.__new__(TTSPipeline)
    live._init_frontend_only()
    return live


def ipa_of(live, text: str) -> str:
    return live.phonemes_to_ipa(live.text_to_phonemes(text))


def zh_words(live):
    import jieba

    path = os.path.join(os.path.dirname(jieba.__file__), "dict.txt")
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            word, freq, _ = line.split()
            if 2 <= len(word) <= 3 and HANZI.match(word):
                rows.append((-int(freq), word))
    out = []
    for _, word in sorted(rows):
        if live.preprocess_text(word) == word:
            out.append(word)
        if len(out) == ZH_WORDS:
            return out
    return out


def en_words(live):
    path = os.path.join(ROOT, "illufly_tts_tpu_torch", "frontend", "g2p",
                        "data", "en_top5k.txt")
    out = []
    with open(path) as f:
        for line in f:
            w = line.strip()
            if (w.isalpha() and w.islower() and w.isascii() and len(w) > 1
                    and live.preprocess_text(w) == w):
                out.append(w)
            if len(out) == EN_WORDS:
                break
    return out


def number_clauses(rng):
    """(language, raw clause) with a number the normalizers rewrite."""
    zh, en = [], []
    for _ in range(30):
        zh.append(f"今天气温{rng.integers(-15, 40)}°C")
        zh.append(f"价格是{rng.integers(1, 999)}.{rng.integers(1, 9)}元")
        zh.append(f"会议定在{rng.integers(1990, 2030)}年{rng.integers(1, 13)}月"
                  f"{rng.integers(1, 29)}日")
        zh.append(f"一共有{rng.integers(2, 5000)}个人")
        zh.append(f"增长了{rng.integers(1, 99)}%")
        en.append(f"it costs ${rng.integers(1, 500)}.{rng.integers(10, 99)}")
        en.append(f"on {MONTHS[rng.integers(0, 12)]} {rng.integers(1, 29)}th")
        en.append(f"about {rng.integers(2, 9000)} people came")
        en.append(f"back in {rng.integers(1950, 2030)}")
        en.append(f"up {rng.integers(1, 99)}% this year")
    return [("zh", c) for c in dict.fromkeys(zh)] + \
        [("en", c) for c in dict.fromkeys(en)]


def main():
    live = live_frontend()
    rng = np.random.default_rng(0)
    zw = zh_words(live)
    ew = en_words(live)
    numbers = []
    for lang, raw in number_clauses(rng):
        norm = live.preprocess_text(raw)
        if lang == "zh" and not HANZI.match(norm):
            continue  # a form the tables cannot spell
        if lang == "en" and not re.fullmatch(r"[a-z ]+", norm):
            continue
        numbers.append((lang, raw, norm))
    chars = sorted(set("".join(zw)) | {c for lang, _, n in numbers
                                       if lang == "zh" for c in n})
    words = sorted(set(ew) | {w for lang, _, n in numbers if lang == "en"
                              for w in n.split()})
    with open(os.path.join(HERE, "zh_words.txt"), "w") as f:
        f.write("\n".join(zw) + "\n")
    with open(os.path.join(HERE, "zh_chars.tsv"), "w") as f:
        f.writelines(f"{c}\t{ipa_of(live, c)}\n" for c in chars)
    with open(os.path.join(HERE, "en_words.tsv"), "w") as f:
        f.writelines(f"{w}\t{ipa_of(live, w)}\n" for w in words)
    with open(os.path.join(HERE, "numbers.tsv"), "w") as f:
        f.writelines(f"{lang}\t{raw}\t{norm}\n" for lang, raw, norm in numbers)
    print(f"{len(zw)} zh words, {len(chars)} characters, {len(words)} en "
          f"words, {len(numbers)} number clauses")


if __name__ == "__main__":
    main()
