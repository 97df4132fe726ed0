# -*- coding: utf-8 -*-
"""English currency verbalization.

Capability parity with the reference's ``normalization/en/currency.py``
(reference: src/illufly_tts/core/normalization/en/currency.py:14-86):
$X.YY -> "N dollars and M cents"; other western currency symbols likewise.
¥/￥ amounts are left for the Chinese path (the pipeline's zh-currency fixup).
"""
from __future__ import annotations

import re

from .num import num_to_words, verbalize_number

CURRENCIES = {
    "$": ("dollar", "cent"),
    "€": ("euro", "cent"),
    "£": ("pound", "penny"),
    "₹": ("rupee", "paisa"),
    "₽": ("ruble", "kopek"),
}

RE_CURRENCY = re.compile(r"([$€£₹₽])\s*(\d+(?:,\d{3})*(?:\.\d+)?)")


def replace_currency(match: re.Match) -> str:
    symbol = match.group(1)
    amount = match.group(2).replace(",", "")
    unit, subunit = CURRENCIES[symbol]
    if "." in amount:
        whole, _, frac = amount.partition(".")
        frac = (frac + "00")[:2]
        whole_int = int(whole or "0")
        frac_int = int(frac)
        parts = []
        if whole_int or not frac_int:
            parts.append(
                f"{verbalize_number(whole_int)} {unit}{'s' if whole_int != 1 else ''}"
            )
        if frac_int:
            if parts:
                parts.append("and")
            parts.append(
                f"{verbalize_number(frac_int)} {subunit}{'s' if frac_int != 1 else ''}"
            )
        return " ".join(parts)
    value = int(amount)
    return f"{verbalize_number(value)} {unit}{'s' if value != 1 else ''}"
