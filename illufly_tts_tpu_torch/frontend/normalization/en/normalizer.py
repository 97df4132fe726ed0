# -*- coding: utf-8 -*-
"""English text normalizer.

Capability parity with the reference's ``EnTextNormalizer``
(reference: src/illufly_tts/core/normalization/en/text_normalization.py:22-255):
URL/email protection via placeholders, then an ordered cascade
(year-range, dates, times, phones, currency, percent, fraction, range,
numbers), then symbol post-pass and placeholder restore.
"""
from __future__ import annotations

import re
from typing import Dict

from .chronology import (
    RE_DATE_ISO,
    RE_DATE_MD,
    RE_DATE_MDY,
    RE_DATE_RANGE_ISO,
    RE_DATE_RANGE_NAMED,
    RE_DATE_RANGE_US,
    RE_DATE_US,
    RE_DAY_RANGE_NAMED,
    RE_TIME,
    RE_YEAR,
    RE_YEAR_RANGE,
    replace_date_iso,
    replace_date_md,
    replace_date_mdy,
    replace_date_range_iso,
    replace_date_range_named,
    replace_date_range_us,
    replace_date_us,
    replace_day_range_named,
    replace_time,
    replace_year,
    replace_year_range,
)
from .currency import RE_CURRENCY, replace_currency
from .num import (
    RE_DECIMAL,
    RE_FRACTION,
    RE_INTEGER,
    RE_NUMBER,
    RE_PERCENT,
    RE_RANGE,
    replace_fraction,
    replace_negative,
    replace_number,
    replace_percent,
    replace_range,
)
from .phone import (
    RE_PHONE_INTL,
    RE_PHONE_US,
    replace_phone,
    replace_phone_intl,
)

RE_URL = re.compile(r"(https?://[^\s<>\"']+|www\.[^\s<>\"']+)")
RE_EMAIL = re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.-]+\b")

_SYMBOL_MAP = {
    "&": " and ",
    "@": " at ",
    "%": " percent ",
    "#": " number ",
    "°": " degrees ",
    "=": " equals ",
}


class EnTextNormalizer:
    """Normalize English text: verbalize NSWs while protecting URLs/emails."""

    def _protect(self, text: str) -> tuple[str, Dict[str, str]]:
        placeholders: Dict[str, str] = {}

        def protect(match: re.Match, kind: str) -> str:
            # Letters-only key so the number cascade never touches it.
            key = f"PROTECTED{kind}{'Q' * (len(placeholders) + 1)}X"
            placeholders[key] = match.group(0)
            return key

        text = RE_URL.sub(lambda m: protect(m, "URL"), text)
        text = RE_EMAIL.sub(lambda m: protect(m, "EMAIL"), text)
        return text, placeholders

    @staticmethod
    def _restore(text: str, placeholders: Dict[str, str]) -> str:
        for key, value in placeholders.items():
            text = text.replace(key, value)
        return text

    def normalize_sentence(self, sentence: str) -> str:
        # date ranges before single dates / year ranges so the longer
        # pattern wins (reference cascade order, text_normalization.py:211-213)
        sentence = RE_DATE_RANGE_US.sub(replace_date_range_us, sentence)
        sentence = RE_DATE_RANGE_ISO.sub(replace_date_range_iso, sentence)
        sentence = RE_DATE_RANGE_NAMED.sub(replace_date_range_named, sentence)
        sentence = RE_DAY_RANGE_NAMED.sub(replace_day_range_named, sentence)
        sentence = RE_YEAR_RANGE.sub(replace_year_range, sentence)
        sentence = RE_DATE_MDY.sub(replace_date_mdy, sentence)
        sentence = RE_DATE_ISO.sub(replace_date_iso, sentence)
        sentence = RE_DATE_US.sub(replace_date_us, sentence)
        sentence = RE_DATE_MD.sub(replace_date_md, sentence)
        sentence = RE_TIME.sub(replace_time, sentence)
        sentence = RE_PHONE_US.sub(replace_phone, sentence)
        sentence = RE_PHONE_INTL.sub(replace_phone_intl, sentence)
        sentence = RE_CURRENCY.sub(replace_currency, sentence)
        sentence = RE_PERCENT.sub(replace_percent, sentence)
        sentence = RE_FRACTION.sub(replace_fraction, sentence)
        sentence = RE_YEAR.sub(replace_year, sentence)
        sentence = RE_RANGE.sub(replace_range, sentence)
        # signed decimals BEFORE bare negative integers — otherwise
        # "-12.5" splits into "minus twelve" + ".5"
        sentence = RE_DECIMAL.sub(replace_number, sentence)
        sentence = RE_INTEGER.sub(replace_negative, sentence)
        sentence = RE_NUMBER.sub(replace_number, sentence)
        return sentence

    def normalize(self, text: str) -> str:
        if not text:
            return text
        text, placeholders = self._protect(text)
        text = self.normalize_sentence(text)
        # Light symbol pass (outside protected spans).
        for symbol, replacement in _SYMBOL_MAP.items():
            if symbol in text:
                text = text.replace(symbol, replacement)
        text = re.sub(r"\s{2,}", " ", text)
        text = self._restore(text, placeholders)
        return text
