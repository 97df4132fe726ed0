# -*- coding: utf-8 -*-
"""English date/time verbalization.

Capability parity with the reference's ``normalization/en/chronology.py``
(reference: src/illufly_tts/core/normalization/en/chronology.py:79-397):
12h clock with am/pm -> "in the morning/afternoon/evening", month/day/year
US-style and ISO dates, year readings (nineteen-XX / twenty-XX /
two-thousand-X), date ranges, and ordinal day names.
"""
from __future__ import annotations

import re

from .num import num_to_words, verbalize_number, verbalize_ordinal

MONTHS = [
    "January", "February", "March", "April", "May", "June", "July",
    "August", "September", "October", "November", "December",
]
_MONTH_ALT = "|".join(MONTHS)

RE_TIME = re.compile(
    r"\b([0-1]?\d|2[0-3]):([0-5]\d)(?::([0-5]\d))?\s*"
    r"(AM|PM|am|pm|a\.m\.|p\.m\.)?\b"
)
RE_DATE_MDY = re.compile(
    rf"\b({_MONTH_ALT})\.?\s+(\d{{1,2}})(st|nd|rd|th)?(?:\s*,\s*|\s+)(\d{{4}})\b",
    re.IGNORECASE,
)
RE_DATE_MD = re.compile(
    rf"\b({_MONTH_ALT})\.?\s+(\d{{1,2}})(st|nd|rd|th)\b", re.IGNORECASE
)
RE_DATE_ISO = re.compile(r"\b(\d{4})[-/](0?[1-9]|1[0-2])[-/](0?[1-9]|[12]\d|3[01])\b")
RE_DATE_US = re.compile(
    r"\b(0?[1-9]|1[0-2])/(0?[1-9]|[12]\d|3[01])/(\d{4})\b"
)
# a bare 4-digit number is a YEAR only in year-ish contexts ("in 1985",
# "since 2008"); elsewhere it's a cardinal ("1000 items" is one thousand,
# not "ten hundred"). The reference reads even "born in 1985" as a
# cardinal (chronology parity sweep, round 2) — context-gating beats both.
_YEARISH = r"(?:1\d{3}|2[01]\d{2})"
RE_YEAR = re.compile(
    rf"\b(in|since|until|till|by|to|circa|around|before|after|during|from|"
    rf"(?:year|summer|winter|spring|fall|autumn|class)\s+of)"
    rf"(\s+)({_YEARISH})(?!\s*[-~]\s*\d)(?!\.\d)(?!\d)",
    re.IGNORECASE,
)
RE_YEAR_RANGE = re.compile(
    rf"\b({_YEARISH})\s*[-~]\s*({_YEARISH})\b"
)
# date ranges (reference en/chronology.py:289-362 reads both numeric forms
# as "from <date> to <date>"; the named-month form covers prose ranges
# like "June 1 - July 4, 2023")
RE_DATE_RANGE_US = re.compile(
    r"\b(?:(from)\s+)?"
    r"(0?[1-9]|1[0-2])/(0?[1-9]|[12]\d|3[01])/(\d{2,4})"
    r"\s*[-~–]\s*"
    r"(0?[1-9]|1[0-2])/(0?[1-9]|[12]\d|3[01])/(\d{2,4})\b",
    re.IGNORECASE,
)
RE_DATE_RANGE_ISO = re.compile(
    r"\b(?:(from)\s+)?"
    r"(\d{4})[-/.](0?[1-9]|1[0-2])[-/.](0?[1-9]|[12]\d|3[01])"
    r"\s*[-~–]\s*"
    r"(\d{4})[-/.](0?[1-9]|1[0-2])[-/.](0?[1-9]|[12]\d|3[01])\b",
    re.IGNORECASE,
)
RE_DATE_RANGE_NAMED = re.compile(
    rf"\b(?:(from)\s+)?"
    rf"({_MONTH_ALT})\.?\s+(\d{{1,2}})(?:st|nd|rd|th)?"
    rf"\s*[-~–]\s*"
    rf"({_MONTH_ALT})\.?\s+(\d{{1,2}})(?:st|nd|rd|th)?"
    rf"(?:\s*,\s*(\d{{4}}))?",
    re.IGNORECASE,
)
RE_DAY_RANGE_NAMED = re.compile(
    rf"\b({_MONTH_ALT})\.?\s+(\d{{1,2}})(?:st|nd|rd|th)?"
    rf"\s*[-~–]\s*(\d{{1,2}})(?:st|nd|rd|th)?\b",
    re.IGNORECASE,
)


def verbalize_year(year: int) -> str:
    """Read a year the natural English way (1368 -> thirteen sixty eight)."""
    if year < 1000 or year > 2999:
        return verbalize_number(year)
    century, rest = divmod(year, 100)
    if rest == 0:
        if century % 10 == 0:
            # 1000/2000 read as cardinals ("two thousand", never
            # "twenty hundred")
            return verbalize_number(year)
        return f"{verbalize_number(century)} hundred"
    if 2000 <= year <= 2009:
        return "two thousand " + verbalize_number(rest)
    if rest < 10:
        return f"{verbalize_number(century)} oh {verbalize_number(rest)}"
    return f"{verbalize_number(century)} {verbalize_number(rest)}"


def replace_time(match: re.Match) -> str:
    hour = int(match.group(1))
    minute = int(match.group(2))
    second = match.group(3)
    meridiem = (match.group(4) or "").lower().replace(".", "")

    suffix = ""
    if meridiem == "am":
        suffix = " in the morning"
    elif meridiem == "pm":
        suffix = " in the evening" if hour >= 6 and hour != 12 else " in the afternoon"

    spoken_hour = hour % 12 or 12 if meridiem else hour
    parts = [verbalize_number(spoken_hour)]
    if minute == 0:
        if meridiem:
            pass  # "ten in the morning"
        else:
            parts.append("o'clock")
    elif minute < 10:
        parts.append("oh " + verbalize_number(minute))
    else:
        parts.append(verbalize_number(minute))
    if second:
        parts.append("and " + verbalize_number(int(second)) + " seconds")
    return " ".join(parts) + suffix


def replace_date_mdy(match: re.Match) -> str:
    month = match.group(1).capitalize()
    day = verbalize_ordinal(int(match.group(2)))
    year = verbalize_year(int(match.group(4)))
    return f"{month} {day} {year}"


def replace_date_md(match: re.Match) -> str:
    month = match.group(1).capitalize()
    day = verbalize_ordinal(int(match.group(2)))
    return f"{month} {day}"


def replace_date_iso(match: re.Match) -> str:
    year = verbalize_year(int(match.group(1)))
    month = MONTHS[int(match.group(2)) - 1]
    day = verbalize_ordinal(int(match.group(3)))
    return f"{month} {day} {year}"


def _year_any(digits: str) -> str:
    """Year text for a 2- or 4-digit year string ('23' -> 2023)."""
    year = int(digits)
    if len(digits) == 2:
        year += 2000
    return verbalize_year(year)


def replace_date_us(match: re.Match) -> str:
    month = MONTHS[int(match.group(1)) - 1]
    day = verbalize_ordinal(int(match.group(2)))
    return f"{month} {day} {verbalize_year(int(match.group(3)))}"


def _from_prefix(existing) -> str:
    # reuse an existing written "from"/"From" instead of doubling it
    return f"{existing} " if existing else "from "


def replace_date_range_us(match: re.Match) -> str:
    frm, m1, d1, y1, m2, d2, y2 = match.groups()
    start = f"{MONTHS[int(m1) - 1]} {verbalize_ordinal(int(d1))} {_year_any(y1)}"
    end = f"{MONTHS[int(m2) - 1]} {verbalize_ordinal(int(d2))} {_year_any(y2)}"
    return f"{_from_prefix(frm)}{start} to {end}"


def replace_date_range_iso(match: re.Match) -> str:
    frm, y1, m1, d1, y2, m2, d2 = match.groups()
    start = f"{MONTHS[int(m1) - 1]} {verbalize_ordinal(int(d1))} {_year_any(y1)}"
    end = f"{MONTHS[int(m2) - 1]} {verbalize_ordinal(int(d2))} {_year_any(y2)}"
    return f"{_from_prefix(frm)}{start} to {end}"


def replace_date_range_named(match: re.Match) -> str:
    frm, m1, d1, m2, d2, year = match.groups()
    start = f"{m1.capitalize()} {verbalize_ordinal(int(d1))}"
    end = f"{m2.capitalize()} {verbalize_ordinal(int(d2))}"
    out = f"{_from_prefix(frm)}{start} to {end}"
    if year:
        out += f" {verbalize_year(int(year))}"
    return out


def replace_day_range_named(match: re.Match) -> str:
    month, d1, d2 = match.groups()
    return (
        f"{month.capitalize()} {verbalize_ordinal(int(d1))}"
        f" to {verbalize_ordinal(int(d2))}"
    )


def replace_year(match: re.Match) -> str:
    return (
        match.group(1) + match.group(2)
        + verbalize_year(int(match.group(3)))
    )


def replace_year_range(match: re.Match) -> str:
    a, b = int(match.group(1)), int(match.group(2))
    # year-range heuristic: historical spans ascend and rarely exceed a
    # few centuries; "1000-2000 units" stays a numeric range
    if not (a < b <= a + 500):
        return match.group(0)
    return f"{verbalize_year(a)} to {verbalize_year(b)}"


__all__ = [
    "RE_TIME", "RE_DATE_MDY", "RE_DATE_MD", "RE_DATE_ISO", "RE_DATE_US",
    "RE_YEAR", "RE_YEAR_RANGE", "RE_DATE_RANGE_US", "RE_DATE_RANGE_ISO",
    "RE_DATE_RANGE_NAMED", "RE_DAY_RANGE_NAMED",
    "replace_time", "replace_date_mdy", "replace_date_md",
    "replace_date_iso", "replace_date_us", "replace_year",
    "replace_year_range", "replace_date_range_us", "replace_date_range_iso",
    "replace_date_range_named", "replace_day_range_named",
    "verbalize_year", "verbalize_ordinal", "num_to_words",
]
