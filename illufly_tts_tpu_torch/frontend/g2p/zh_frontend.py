# -*- coding: utf-8 -*-
"""Chinese frontend: segmentation -> pinyin -> sandhi -> erhua -> zhuyin.

Fresh implementation of the capability surveyed from the reference's
``ZHFrontend`` (reference: src/illufly_tts/core/g2p/zh_frontend.py:44-231):
jieba POS segmentation, sandhi pre-merge, strict initial/final extraction
(zi/ci/si -> ii, zhi/chi/shi -> iii, 嗯 -> n2), tone sandhi, erhua merge with
must/not word lists, and a zhuyin phoneme string with '/' word separators.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import jieba
import jieba.posseg as psg

from .pinyin.engine import split_initial_final, word_pinyin
from .pinyin.phrases import POS_READINGS
from .tokens import MToken
from .tone_sandhi import ToneSandhi
from ..normalization.zh.chars import traditional_to_simplified
from .zhuyin import syllable_to_zhuyin

_CJK = re.compile(r"[一-鿿]")

PUNCT = frozenset(';:,.!?—…"()“” ')

MUST_ERHUA = {
    "小院儿", "胡同儿", "范儿", "老头儿", "撒欢儿", "妥妥儿", "媳妇儿",
    "一会儿", "一块儿", "一点儿", "有点儿", "这儿", "那儿", "哪儿",
    "玩儿", "份儿", "劲儿", "味儿", "事儿", "活儿", "空儿", "门儿",
}
NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "救儿", "有儿", "一儿", "我儿", "妻儿",
    "幼儿", "孤儿", "婴儿", "婴幼儿", "连体儿", "流浪儿", "混血儿",
    "女儿", "男儿", "花儿", "虫儿", "马儿", "鸟儿", "猪儿", "猫儿",
    "狗儿", "少儿", "患儿", "乞儿", "聋儿", "侄儿", "孙儿",
}


# real lexical compounds jieba splits because the first char is a frequent
# function word; registering them recovers the phrase-level reading the
# reference gets from pypinyin's large_pinyin (ref zh_frontend.py:26,85)
for _w, _t in (("还钱", "v"), ("转着", "v"), ("大喝", "v"),
               ("倒是", "d"), ("倒进", "v"), ("倒入", "v"),
               ("倒出", "v"), ("倒掉", "v"), ("抹平", "v")):
    jieba.add_word(_w, tag=_t)


# word -> (initials, finals) memo. The lookup is pure in `word` (phrase
# table + per-char defaults + i/ii/iii recoding), and serving text repeats
# words heavily, so this removes ~1/3 of the zh frontend's per-batch CPU
# (the frontend is host-side work that competes with the dispatch loop —
# bench.py e2e scenario). Values are stored as tuples and copied out
# because downstream sandhi/erhua mutate the lists in place. Cleared by
# custom_dict.load_zh_dict (the only runtime mutation of the tables).
_IF_CACHE: dict = {}
_IF_CACHE_MAX = 100_000


def clear_frontend_caches() -> None:
    _IF_CACHE.clear()
    from .tone_sandhi import clear_sandhi_cache

    clear_sandhi_cache()


class ZHFrontend:
    def __init__(self, unk: str = "❓"):
        self.unk = unk
        self.tone_modifier = ToneSandhi()

    def _get_initials_finals(
        self, word: str
    ) -> Tuple[List[str], List[str]]:
        hit = _IF_CACHE.get(word)
        if hit is not None:
            return list(hit[0]), list(hit[1])
        initials: List[str] = []
        finals: List[str] = []
        for ch, py in zip(word, word_pinyin(word)):
            if py is None:
                initials.append(None)
                finals.append(None)
                continue
            if ch == "嗯":
                # pypinyin>=0.44 compatibility quirk kept by the reference
                # (zh_frontend.py:100-103): 嗯 reads as n2.
                initials.append("")
                finals.append("n2")
                continue
            initial, final = split_initial_final(py)
            if re.match(r"i\d", final):
                if initial in ("z", "c", "s"):
                    final = "ii" + final[1:]
                elif initial in ("zh", "ch", "sh", "r"):
                    final = "iii" + final[1:]
            initials.append(initial)
            finals.append(final)
        if len(_IF_CACHE) < _IF_CACHE_MAX:
            _IF_CACHE[word] = (tuple(initials), tuple(finals))
        return initials, finals

    def _merge_erhua(
        self,
        initials: List[str],
        finals: List[str],
        word: str,
        pos: str,
    ) -> Tuple[List[str], List[str]]:
        # standalone 儿 at word end reads er2 not er1
        for i, phn in enumerate(finals):
            if (
                i == len(finals) - 1
                and i < len(word)
                and word[i] == "儿"
                and phn == "er1"
            ):
                finals[i] = "er2"
        if word not in MUST_ERHUA and (
            word in NOT_ERHUA or pos in {"a", "j", "nr"}
        ):
            return initials, finals
        if len(finals) != len(word):
            return initials, finals
        new_initials: List[str] = []
        new_finals: List[str] = []
        for i, phn in enumerate(finals):
            if (
                i == len(finals) - 1
                and word[i] == "儿"
                and phn in ("er2", "er5")
                and word[-2:] not in NOT_ERHUA
                and new_finals
                and new_finals[-1]
            ):
                # merge: previous final gains an R before its tone digit
                prev = new_finals[-1]
                new_finals[-1] = prev[:-1] + "R" + prev[-1]
            else:
                new_initials.append(initials[i])
                new_finals.append(phn)
        return new_initials, new_finals

    def __call__(self, text: str, with_erhua: bool = True):
        tokens: List[MToken] = []
        pending = []  # (token, initials, finals) awaiting cross-word sandhi
        # traditional input reads correctly even without the normalizer
        # pre-pass (the reference gets this from pypinyin's trad-aware
        # dict; we convert before segmentation -- jieba also segments
        # simplified text better)
        text = traditional_to_simplified(text)
        seg_cut = psg.lcut(text)
        seg_cut = [(w, p) for w, p in seg_cut]
        seg_cut = self.tone_modifier.pre_merge_for_modify(seg_cut)
        # sentence-context polyphone overrides (pinyin/context_rules.py):
        # readings POS tags can't separate (当/转/吐 verb-verb pairs, jieba
        # glue-words like 火着/他中/先量)
        from .pinyin.context_rules import context_overrides

        ctx_over = context_overrides(seg_cut, text)

        for w_idx, (word, pos) in enumerate(seg_cut):
            if pos == "x" and word and _CJK.match(min(word)) and _CJK.match(max(word)):
                pos = "X"
            elif pos != "x" and word in PUNCT:
                pos = "x"
            tk = MToken(text=word, tag=pos, whitespace="")
            if pos in ("x", "eng"):
                if not word.isspace():
                    if pos == "x" and all(c in PUNCT for c in word):
                        tk.phonemes = word
                    tokens.append(tk)
                elif tokens:
                    tokens[-1].whitespace += word
                continue
            elif tokens and tokens[-1].tag not in ("x", "eng") \
                    and not tokens[-1].whitespace:
                tokens[-1].whitespace = "/"

            initials, finals = self._get_initials_finals(word)
            # single-char polyphones whose reading tracks word class: use
            # the jieba POS tag (the reference gets the same disambiguation
            # from pypinyin phrase data + jieba, ref zh_frontend.py:26,85)
            if len(word) == 1 and word in POS_READINGS:
                by_pos = POS_READINGS[word]
                reading = by_pos.get(pos[:1])
                if reading is not None:
                    initial, final = split_initial_final(reading)
                    if re.match(r"i\d", final):
                        if initial in ("z", "c", "s"):
                            final = "ii" + final[1:]
                        elif initial in ("zh", "ch", "sh", "r"):
                            final = "iii" + final[1:]
                    initials, finals = [initial], [final]
            known = [f for f in finals if f is not None]
            if len(known) == len(finals):
                finals = self.tone_modifier.modified_tone(word, pos, finals)
            # sentence-context overrides win over the dictionary, the POS
            # table AND tone sandhi (得→dei3 must survive the 的地得
            # neutralization); they fire only on their narrow patterns
            for ci in range(len(word)):
                reading = ctx_over.get((w_idx, ci))
                if reading is None or ci >= len(finals):
                    continue
                initial, final = split_initial_final(reading)
                if re.match(r"i\d", final):
                    if initial in ("z", "c", "s"):
                        final = "ii" + final[1:]
                    elif initial in ("zh", "ch", "sh", "r"):
                        final = "iii" + final[1:]
                initials[ci] = initial
                finals[ci] = final
            if len(known) == len(finals):
                if with_erhua:
                    initials, finals = self._merge_erhua(
                        initials, finals, word, pos
                    )
            tk.phonemes = None  # filled after cross-word sandhi
            tokens.append(tk)
            pending.append((len(tokens) - 1, tk, initials, finals))

        # cross-word third-tone sandhi: a word-final tone 3 followed by a
        # word-initial tone 3 in the same breath group (adjacent tokens, no
        # punctuation between) becomes tone 2. Within-word runs are already
        # handled by ToneSandhi.
        for p in range(len(pending) - 1):
            pos_i, tk, _, finals = pending[p]
            pos_j, _, _, nxt_finals = pending[p + 1]
            if pos_j != pos_i + 1:
                continue  # punctuation or English between
            if not finals or not nxt_finals:
                continue
            last = finals[-1]
            first = nxt_finals[0]
            if last and first and last.endswith("3") and first.endswith("3"):
                finals[-1] = last[:-1] + "2"

        for _, tk, initials, finals in pending:
            phonemes = []
            for c, v in zip(initials, finals):
                if v is None:
                    phonemes.append(self.unk)
                    continue
                zy = syllable_to_zhuyin(c or "", v)
                phonemes.append(zy if zy else self.unk)
            tk.phonemes = "".join(phonemes)

        result = "".join(
            (self.unk if tk.phonemes is None else tk.phonemes) + tk.whitespace
            for tk in tokens
        )
        return result, tokens
