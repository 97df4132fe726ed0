# -*- coding: utf-8 -*-
"""English number verbalization.

Capability parity with the reference's ``normalization/en/num.py`` +
``constants.py`` (reference: src/illufly_tts/core/normalization/en/num.py:28-257):
cardinals through quadrillions, ordinals, decimals, fractions with special
cases (half/third/quarter + plurals), percentages, ranges, signed integers.
Implemented from scratch (the reference leans on num2words, which is not
available here).
"""
from __future__ import annotations

import re

ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
MAGNITUDES = [
    (10**15, "quadrillion"),
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (100, "hundred"),
]
ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def verbalize_number(value: int) -> str:
    """Verbalize a non-negative integer as English words (no hyphens/and)."""
    if value < 0:
        return "minus " + verbalize_number(-value)
    if value < 20:
        return ONES[value]
    if value < 100:
        tens, ones = divmod(value, 10)
        return TENS[tens] + ("" if ones == 0 else " " + ONES[ones])
    for magnitude, name in MAGNITUDES:
        if value >= magnitude:
            major, remainder = divmod(value, magnitude)
            text = verbalize_number(major) + " " + name
            if remainder:
                text += " " + verbalize_number(remainder)
            return text
    raise AssertionError("unreachable")


def verbalize_digits(value_string: str) -> str:
    """Digit-by-digit reading, 'oh' style zero avoided (plain 'zero')."""
    return " ".join(ONES[int(d)] for d in value_string if d.isdigit())


def verbalize_ordinal(value: int) -> str:
    words = verbalize_number(value).split()
    last = words[-1]
    if last in ORDINAL_SPECIAL:
        words[-1] = ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def num_to_words(value_string: str) -> str:
    """Verbalize a number string that may carry a sign and a decimal part."""
    value_string = value_string.strip().replace(",", "")
    sign = ""
    if value_string.startswith("-"):
        sign = "minus "
        value_string = value_string[1:]
    elif value_string.startswith("+"):
        sign = "plus "
        value_string = value_string[1:]
    if "." in value_string:
        integer, _, fraction = value_string.partition(".")
        fraction = fraction.rstrip("0")
        parts = [verbalize_number(int(integer or "0"))]
        if fraction:
            parts.append("point")
            parts.append(verbalize_digits(fraction))
        return sign + " ".join(parts)
    return sign + verbalize_number(int(value_string or "0"))


# --- regex replacers ---------------------------------------------------------

# A leading '-' counts as a minus sign only when it is not an intra-word
# hyphen ("9-to-5", "x-5"): require a non-alphanumeric left context.
RE_NUMBER = re.compile(
    r"((?<![A-Za-z0-9])-)?(\d+(?:,\d{3})*(?:\.\d+)?|\.\d+)"
)
RE_PERCENT = re.compile(r"((?<![A-Za-z0-9])-)?(\d+(?:\.\d+)?)\s*%")
RE_FRACTION = re.compile(r"(?<![\d.])(\d+)\s*/\s*(\d+)(?![\d.])")
RE_RANGE = re.compile(r"(\d+(?:\.\d+)?)\s*[-~]\s*(\d+(?:\.\d+)?)")
RE_DECIMAL = re.compile(r"((?<![A-Za-z0-9])-)?(\d+\.\d+)")
RE_INTEGER = re.compile(r"((?<![A-Za-z0-9])-)(\d+)")

_FRACTION_UNITS = {2: ("half", "halves"), 4: ("quarter", "quarters")}


def replace_number(match: re.Match) -> str:
    sign = "minus " if match.group(1) else ""
    return sign + num_to_words(match.group(2))


def replace_percent(match: re.Match) -> str:
    sign = "minus " if match.group(1) else ""
    return f"{sign}{num_to_words(match.group(2))} percent"


def replace_fraction(match: re.Match) -> str:
    numerator = int(match.group(1))
    denominator = int(match.group(2))
    if denominator == 0:
        return match.group(0)
    if denominator in _FRACTION_UNITS:
        singular, plural = _FRACTION_UNITS[denominator]
        unit = singular if numerator == 1 else plural
    else:
        unit = verbalize_ordinal(denominator)
        if numerator != 1:
            unit += "s"
    return f"{verbalize_number(numerator)} {unit}"


def replace_range(match: re.Match) -> str:
    return f"{num_to_words(match.group(1))} to {num_to_words(match.group(2))}"


def replace_negative(match: re.Match) -> str:
    return "minus " + num_to_words(match.group(2))
