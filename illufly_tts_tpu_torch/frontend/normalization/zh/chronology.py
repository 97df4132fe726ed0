# -*- coding: utf-8 -*-
"""Chinese date / time verbalization.

Capability parity with the reference's ``normalization/zh/chronology.py``
(reference: src/illufly_tts/core/normalization/zh/chronology.py:32-190):
HH:MM[:SS] clock readings (30min -> 半), 年/月/日 dates, ISO YYYY-MM-DD dates,
and year ranges read digit-wise (1644~1911年 -> 一六四四年至一九一一年).
"""
from __future__ import annotations

import re

from .num import DIGITS, num2str, verbalize_cardinal, verbalize_digit

RE_TIME = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
)
RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"(~|-)"
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
)
RE_DATE = re.compile(
    r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?"
)
RE_DATE2 = re.compile(
    r"(\d{4})([-/.])(0[1-9]|1[0-2])\2(0[1-9]|[1-2][0-9]|30|31)"
)
RE_YEAR_RANGE = re.compile(r"(\d{4})[-~](\d{4})年")


def _time_digits(num_string: str) -> str:
    """Time minutes/seconds keep a leading zero (reference
    _time_num2str, chronology.py:23-28): "05" -> 零五."""
    result = verbalize_cardinal(num_string.lstrip("0") or "0")
    if num_string.startswith("0") and num_string.lstrip("0"):
        result = "零" + result
    return result


def _time_to_str(
    hour: str, minute: str, second: str | None, allow_ban: bool = True
) -> str:
    result = f"{num2str(hour)}点"
    minute_int = int(minute)
    if minute_int == 30 and allow_ban:
        result += "半"
    elif minute_int != 0:
        result += f"{_time_digits(minute)}分"
    if second and int(second) != 0:
        result += f"{_time_digits(second)}秒"
    return result


def replace_time(match: re.Match) -> str:
    return _time_to_str(match.group(1), match.group(2), match.group(4))


def replace_time_range(match: re.Match) -> str:
    # the reference's range reader gates the SECOND half's 半 on the
    # FIRST half's minute (chronology.py:78, a bug: "6:30-9:45" ->
    # 六点半至九点半). The second half here reads 半 only when BOTH
    # minutes are 30 — bit-identical to the reference everywhere except
    # its buggy first==30 && second not in {0, 30} case, where it emits
    # a wrong 半 and we read the real minutes (pinned in
    # tests/test_reference_parity.py).
    first = _time_to_str(
        match.group(1), match.group(2), match.group(4), allow_ban=True
    )
    second = _time_to_str(
        match.group(6), match.group(7), match.group(9),
        allow_ban=int(match.group(2)) == 30 and int(match.group(7)) == 30,
    )
    return f"{first}至{second}"


def replace_date(match: re.Match) -> str:
    year = match.group(1)
    month = match.group(3)
    day = match.group(5)
    day_suffix = match.group(9)
    result = ""
    if year:
        result += verbalize_digit(year) + "年"
    if month:
        result += verbalize_cardinal(month) + "月"
    if day:
        result += verbalize_cardinal(day) + (day_suffix or "日")
    return result


def replace_date2(match: re.Match) -> str:
    year, month, day = match.group(1), match.group(3), match.group(4)
    return (
        verbalize_digit(year) + "年"
        + verbalize_cardinal(month) + "月"
        + verbalize_cardinal(day) + "日"
    )


def replace_year_range(match: re.Match) -> str:
    first, second = match.group(1), match.group(2)
    return f"{verbalize_digit(first)}年至{verbalize_digit(second)}年"


def digits_to_chinese(value_string: str) -> str:
    return "".join(DIGITS.get(ch, ch) for ch in value_string)
