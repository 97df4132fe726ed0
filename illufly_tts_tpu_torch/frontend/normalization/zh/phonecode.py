# -*- coding: utf-8 -*-
"""Chinese phone-number verbalization.

Capability parity with the reference's ``normalization/zh/phonecode.py``
(reference: src/illufly_tts/core/normalization/zh/phonecode.py:24-63):
mainland mobile numbers (optional +86), landlines with area codes, and
400 service numbers — all read digit-by-digit with 幺 for 1.
"""
from __future__ import annotations

import re

from .num import verbalize_digit

# Mainland mobile: 13x/14x/15x/16x/17x/18x/19x + 8 digits, optional +86.
RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86[ -]?)?1[3-9]\d{9})(?!\d)"
)
RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})[- ]?)?[1-9]\d{6,7})(?!\d)"
)
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)([- ])?(\d{3})\2?(\d{4})")


def phone2str(phone_string: str, mobile: bool = True) -> str:
    if mobile:
        sp_parts = phone_string.strip("+").split()
        result = "，".join(
            verbalize_digit(part, alt_one=True) for part in sp_parts
        )
    else:
        sil_parts = phone_string.split("-")
        result = "，".join(
            verbalize_digit(part, alt_one=True) for part in sil_parts
        )
    return result


def replace_mobile(match: re.Match) -> str:
    return phone2str(match.group(0))


def replace_phone(match: re.Match) -> str:
    return phone2str(match.group(0), mobile=False)


def replace_400(match: re.Match) -> str:
    # pause commas at the written separators only (reference phone2str
    # splits on '-', phonecode.py:40-43): "400-123-4567" gets pauses,
    # "4001234567" reads straight through
    if match.group(2):
        groups = ("400", match.group(3), match.group(4))
        return "，".join(verbalize_digit(g, alt_one=True) for g in groups)
    return verbalize_digit(
        "400" + match.group(3) + match.group(4), alt_one=True
    )
