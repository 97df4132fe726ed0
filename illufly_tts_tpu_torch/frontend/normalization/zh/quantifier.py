# -*- coding: utf-8 -*-
"""Chinese temperature / measure-unit verbalization.

Capability parity with the reference's ``normalization/zh/quantifier.py``
(reference: src/illufly_tts/core/normalization/zh/quantifier.py:20-66):
temperatures (incl. 气温 context and 零下) and compound measure units.
"""
from __future__ import annotations

import re

from .num import num2str

RE_TEMPERATURE = re.compile(
    r"(-?)(\d+(?:\.\d+)?)(°C|℃|度|摄氏度)"
)

MEASURE_MAP = {
    "cm2": "平方厘米",
    "cm²": "平方厘米",
    "cm3": "立方厘米",
    "cm³": "立方厘米",
    "cm": "厘米",
    "db": "分贝",
    "ds": "毫秒",
    "kg": "千克",
    "km": "千米",
    "m2": "平方米",
    "m²": "平方米",
    "m³": "立方米",
    "m3": "立方米",
    "ml": "毫升",
    "m": "米",
    "mm": "毫米",
    "s": "秒",
    "h": "小时",
    "mg": "毫克",
}


def replace_temperature(match: re.Match) -> str:
    sign = match.group(1)
    temperature = match.group(2)
    unit = match.group(3)
    sign = "零下" if sign else ""
    temperature = num2str(temperature)
    unit = "摄氏度" if unit in ("°C", "℃", "摄氏度") else "度"
    return f"{sign}{temperature}{unit}"


def replace_measure(sentence: str) -> str:
    """Digit- or slash-anchored (unlike the reference's bare
    str.replace, quantifier.py:62-66, which rewrites unit letters inside
    ordinary words): "70km/h" -> "70千米/小时" (the /->每 post-replace
    then yields 千米每小时)."""
    # longest notation first: 'mg'/'mm' must beat the bare 'm' entry
    for q_notation in sorted(MEASURE_MAP, key=len, reverse=True):
        q_name = MEASURE_MAP[q_notation]
        sentence = re.sub(
            rf"(\d|/)(?:{re.escape(q_notation)})",
            rf"\g<1>{q_name}", sentence
        )
    return sentence
