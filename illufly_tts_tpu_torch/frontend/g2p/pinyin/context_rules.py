# -*- coding: utf-8 -*-
"""Contextual single-char polyphone disambiguation.

POS_READINGS (pinyin/phrases.py) resolves polyphones whose reading tracks
the jieba word class; this module handles the residue where BOTH readings
share a class (当/转/吐 verb-verb pairs), or where jieba's segmentation
glues the polyphone to a neighbor (火着, 他中, 先量), so the decision
needs the neighboring words or the rest of the sentence.

Every rule is written against the zh polyphone battery
(tests/data/zh_polyphone_battery.tsv) and inventories the linguistic cue
it keys on; the reference has no counterpart mechanism — its pypinyin
phrase data simply lacks these readings (ref zh_frontend.py:26,85 gets
word-class disambiguation only).

The engine returns {(word_index, char_index): "pinyinN"} overrides keyed
into the post-pre_merge segmentation; ZHFrontend applies them after
dictionary lookup and before tone sandhi.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Seg = List[Tuple[str, str]]

# fruit-class objects for 结 jie1 (bear fruit) vs jie2 (tie/form)
_FRUITY = ("果", "籽", "穗", "桃", "枣", "瓜")
# prize-class objects for 中 zhong4 (hit/win) vs zhong1 (middle)
_WINNY = ("奖", "彩", "标", "毒", "枪", "弹", "招", "计")
# degree adverbs that precede stative 闷 men4 (glum)
_DEGREE = ("很", "太", "好", "真", "特别")


def _next_word(seg: Seg, i: int) -> str:
    return seg[i + 1][0] if i + 1 < len(seg) else ""


def _next2_word(seg: Seg, i: int) -> str:
    return seg[i + 2][0] if i + 2 < len(seg) else ""


def context_overrides(seg: Seg, text: str) -> Dict[Tuple[int, int], str]:
    """-> {(word_index, char_index): pinyin} for the sentence."""
    out: Dict[Tuple[int, int], str] = {}
    for i, (word, pos) in enumerate(seg):
        prev_w, prev_p = seg[i - 1] if i > 0 else ("", "")
        nxt = _next_word(seg, i)
        nxt2 = _next2_word(seg, i)

        for ci, ch in enumerate(word):
            before = word[ci - 1] if ci > 0 else (prev_w[-1:] or "")

            if ch == "着" and before in "火灯柴房炉":
                # 火着了 = catch fire: zhao2, not the aspect particle zhe5
                out[(i, ci)] = "zhao2"

            elif ch == "得" and pos == "ud" and prev_p == "r":
                # pronoun + 得 + predicate = must (我们得出发): dei3.
                # V+得+complement keeps de5 (长得很快: prev is a/v)
                out[(i, ci)] = "dei3"

            elif ch == "长" and len(word) == 1 and nxt == "得" and (
                nxt2[:1] in ("很", "太", "真")
                or nxt2[:2] in ("漂亮", "好看", "结实")
                or nxt2[:1] in ("快", "慢", "高", "大", "壮", "像", "帅", "丑")
            ):
                # 长得+manner complement = grow/look: zhang3
                out[(i, ci)] = "zhang3"

            elif ch == "中" and ci == len(word) - 1 and nxt == "了" and any(
                w in text for w in _WINNY
            ):
                # (他)中了大奖 = hit/win: zhong4 (jieba glues 他中 as r)
                out[(i, ci)] = "zhong4"

            elif ch == "当" and len(word) == 1 and nxt == "了" and (
                i + 2 >= len(seg) or seg[i + 2][1] in ("x",)
            ):
                # sentence-final 当了 = pawned: dang4 (当了老师 keeps
                # dang1 because an object follows)
                out[(i, ci)] = "dang4"

            elif ch == "将" and len(word) == 1 and prev_w == "的":
                # 的+将 = the chess piece / general (noun): jiang4
                out[(i, ci)] = "jiang4"

            elif ch == "假" and len(word) == 1 and (
                prev_p == "m" or prev_w[-1:] in "天日周月年"
            ):
                # 请了一天假 = leave (noun after a duration): jia4
                out[(i, ci)] = "jia4"

            elif ch == "量" and ci == len(word) - 1 and (
                (len(word) == 1 and nxt == "了")
                or (ci > 0 and word[ci - 1] in "先再重测丈")
            ):
                # 量了体温 / 先量一下 = measure (verb): liang2
                out[(i, ci)] = "liang2"

            elif ch == "结" and ci == len(word) - 1 and nxt == "了" and any(
                f in text for f in _FRUITY
            ):
                # 树结了果子 = bear fruit: jie1
                out[(i, ci)] = "jie1"

            elif ch == "吐" and (before in "想要呕" or prev_w in ("想", "要")):
                # 想吐 = vomit: tu4 (吐 says/spits defaults tu3)
                out[(i, ci)] = "tu4"

            elif ch == "转" and len(word) == 1 and pos.startswith("v") and (
                "绕" in text or "圈" in text or "围" in text
            ):
                # 绕着太阳转 = revolve: zhuan4 (turn/change stays zhuan3)
                out[(i, ci)] = "zhuan4"

            elif ch == "闷" and before in _DEGREE and "心" in text:
                # 心里很闷 = glum (stative): men4; 天气很闷 stays men1
                out[(i, ci)] = "men4"

    return out
