# -*- coding: utf-8 -*-
"""Chinese text normalizer: NSW (non-standard word) verbalization cascade.

Capability parity with the reference's ``ZhTextNormalizer``
(reference: src/illufly_tts/core/normalization/zh/text_normalization.py:30-135):
sentence split, traditional->simplified + fullwidth folding, then an ordered
regex cascade (year-range, dates, times, temperature, measures, fractions,
percentages, phone numbers, ranges, numbers), then a symbol post-pass.
"""
from __future__ import annotations

import re
from typing import List

from .chars import fullwidth_to_halfwidth, traditional_to_simplified
from .chronology import (
    RE_DATE,
    RE_DATE2,
    RE_TIME,
    RE_TIME_RANGE,
    RE_YEAR_RANGE,
    replace_date,
    replace_date2,
    replace_time,
    replace_time_range,
    replace_year_range,
)
from .num import (
    RE_DECIMAL_NUM,
    RE_DEFAULT_NUM,
    RE_FRAC,
    RE_INTEGER,
    RE_NUMBER,
    RE_PERCENTAGE,
    RE_POSITIVE_QUANTIFIERS,
    RE_RANGE,
    replace_default_num,
    replace_frac,
    replace_negative_num,
    replace_number,
    replace_percentage,
    replace_positive_quantifier,
    replace_range,
)
from .phonecode import (
    RE_MOBILE_PHONE,
    RE_NATIONAL_UNIFORM_NUMBER,
    RE_TELEPHONE,
    replace_400,
    replace_mobile,
    replace_phone,
)
from .quantifier import RE_TEMPERATURE, replace_measure, replace_temperature

_SENTENCE_SPLITTER = re.compile(r"(?<=[：、，；。？！,;?!])")

_POST_REPLACEMENTS = {
    "/": "每",
    "~": "至",
    "～": "至",
    "①": "一",
    "②": "二",
    "③": "三",
    "④": "四",
    "⑤": "五",
    "⑥": "六",
    "⑦": "七",
    "⑧": "八",
    "⑨": "九",
    "⑩": "十",
    "α": "阿尔法",
    "β": "贝塔",
    "γ": "伽玛",
    "Γ": "伽玛",
    "δ": "德尔塔",
    "Δ": "德尔塔",
    "θ": "西塔",
    "λ": "拉姆达",
    "μ": "缪",
    "π": "派",
    "Ω": "欧米伽",
    "ω": "欧米伽",
    "+": "加",
    "=": "等于",
}
_RE_BRACKETS = re.compile(r"[【】〖〗〔〕\[\]「」『』]")
# thousand-separated numbers: 1-3 leading digits then comma-separated
# triples (optional decimals), not already inside a longer digit run
_RE_COMMA_NUM = re.compile(r"(?<!\d)\d{1,3}(?:,\d{3})+(?:\.\d+)?(?!\d)")


def _collapse_comma_num(match: re.Match) -> str:
    digits = match.group(0).replace(",", "")
    # thousand separators mark an unambiguous cardinal — verbalize
    # immediately at EVERY size: a bare 4-6 digit collapse would fall to
    # the serial rule (digit-wise with 幺) and 7-8 digits would collide
    # with the landline rule
    if "." not in digits:
        from .num import num2str

        return num2str(digits)
    return digits


# sentence -> normalized memo (see normalize_sentence)
_SENT_CACHE: dict = {}


class ZhTextNormalizer:
    """Normalize Chinese text: split into sentences and verbalize NSWs."""

    def _split(self, text: str) -> List[str]:
        text = text.replace("\n", "").strip()
        if not text:
            return []
        sentences = [s for s in _SENTENCE_SPLITTER.split(text) if s]
        return sentences

    def _post_replace(self, sentence: str) -> str:
        for old, new in _POST_REPLACEMENTS.items():
            sentence = sentence.replace(old, new)
        sentence = _RE_BRACKETS.sub("", sentence)
        return sentence

    def normalize_sentence(self, sentence: str) -> str:
        # pure str->str regex cascade: memoize — serving text repeats
        # sentences (boilerplate, retries, shared prompts) and the NSW
        # cascade is ~half the normalizer's CPU
        hit = _SENT_CACHE.get(sentence)
        if hit is not None:
            return hit
        out = self._normalize_sentence_uncached(sentence)
        if len(_SENT_CACHE) < 20_000:
            _SENT_CACHE[sentence] = out
        return out

    def _normalize_sentence_uncached(self, sentence: str) -> str:
        sentence = traditional_to_simplified(sentence)
        sentence = fullwidth_to_halfwidth(sentence)

        # Ordered NSW cascade — ordering matters (e.g. year ranges before
        # generic ranges, percentages before decimals).
        sentence = RE_YEAR_RANGE.sub(replace_year_range, sentence)
        sentence = RE_DATE.sub(replace_date, sentence)
        sentence = RE_DATE2.sub(replace_date2, sentence)
        sentence = RE_TIME_RANGE.sub(replace_time_range, sentence)
        sentence = RE_TIME.sub(replace_time, sentence)
        sentence = RE_TEMPERATURE.sub(replace_temperature, sentence)
        sentence = replace_measure(sentence)
        sentence = RE_FRAC.sub(replace_frac, sentence)
        sentence = RE_PERCENTAGE.sub(replace_percentage, sentence)
        sentence = RE_MOBILE_PHONE.sub(replace_mobile, sentence)
        sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(replace_400, sentence)
        sentence = RE_TELEPHONE.sub(replace_phone, sentence)
        sentence = RE_RANGE.sub(replace_range, sentence)
        sentence = RE_INTEGER.sub(replace_negative_num, sentence)
        sentence = RE_DECIMAL_NUM.sub(replace_number, sentence)
        sentence = RE_POSITIVE_QUANTIFIERS.sub(
            replace_positive_quantifier, sentence
        )
        sentence = RE_DEFAULT_NUM.sub(replace_default_num, sentence)
        sentence = RE_NUMBER.sub(replace_number, sentence)
        sentence = self._post_replace(sentence)
        return sentence

    def normalize(self, text: str) -> List[str]:
        # collapse thousand separators BEFORE sentence splitting — the
        # splitter breaks on ASCII commas, which is exactly how the
        # reference ends up dropping digits from "300,000"
        text = _RE_COMMA_NUM.sub(_collapse_comma_num, text)
        sentences = self._split(text)
        return [self.normalize_sentence(s) for s in sentences]
