# -*- coding: utf-8 -*-
"""English phone-number verbalization.

Capability parity with the reference's ``normalization/en/phone.py`` and
``phonecode.py`` (reference: src/illufly_tts/core/normalization/en/phone.py:4-52,
phonecode.py:14-99): US (XXX) XXX-XXXX, international +N-XXX-... — read
digit-by-digit in groups separated by short pauses (commas).
"""
from __future__ import annotations

import re

from .num import verbalize_digits

RE_PHONE_US = re.compile(
    r"(?<!\d)(\+?1[-\s.])?(\(\d{3}\)\s?|\d{3}[-\s.])\d{3}[-\s.]\d{4}(?!\d)"
)
RE_PHONE_INTL = re.compile(
    r"(?<![\d\w])\+\d{1,3}(?:[-\s.]\d{2,4}){2,5}(?!\d)"
)


def _read_grouped(number_text: str) -> str:
    groups = re.findall(r"\d+", number_text)
    return ", ".join(verbalize_digits(g) for g in groups if g)


def replace_phone(match: re.Match) -> str:
    return _read_grouped(match.group(0))


def replace_phone_intl(match: re.Match) -> str:
    return "plus " + _read_grouped(match.group(0))
