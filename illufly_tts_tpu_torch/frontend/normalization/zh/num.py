# -*- coding: utf-8 -*-
"""Chinese number verbalization (NSW -> hanzi).

Fresh implementation of the capability surveyed from the reference's
``normalization/zh/num.py`` (reference: src/illufly_tts/core/normalization/zh/num.py:22-238):
cardinals with 万/亿 grouping, digit-by-digit serial reading with 幺 for 1,
fractions (x/y -> y分之x), percentages, decimals, signed integers, numeric
ranges, and quantifier-attached numbers.
"""
from __future__ import annotations

import re

DIGITS = {str(i): c for i, c in enumerate("零一二三四五六七八九")}
UNITS = {1: "", 2: "十", 3: "百", 4: "千", 5: "万", 9: "亿"}

# Common measure words used to detect "number + quantifier" patterns.
COM_QUANTIFIERS = (
    "(元|块|角|毛|人|所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|"
    "壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|"
    "双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|"
    "毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|(公)分|分|寸|尺|丈|"
    "里|寻|常|铺|程|(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|"
    "时|周|天|秒|分|小时|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|"
    "堆|条|根|支|道|面|片|块|蓬|束|捆|团|组|批|段|股|伙|项|例|列|篇|栋|栏|轮|架|"
    "捧|棒|串|射|枚|竿|锭|筒|杆|趟|盘|把|末|卷|谱|秩|胡|类|种|番|届|轮|遭|遍|番|"
    "次|步|路|级|排|行|套|部|台|处|座|点|摊|门|克|千克|公斤|吨|升|毫升|度|摄氏度|"
    "千米|公里|英里|海里|亩|顷|平方米|立方米|"
    # bare magnitudes LAST so 千米/千克 alternatives win at the same
    # position (reference num.py:31 trailing (亿|千万|百万|万|千|百) group;
    # makes "1200万" read 一千二百万, not serial digits)
    "亿|千万|百万|万|千|百)"
)


def verbalize_digit(value_string: str, alt_one: bool = False) -> str:
    """Read digits one by one; ``alt_one`` uses 幺 for 1 (phone numbers)."""
    result = "".join(DIGITS[d] for d in value_string if d in DIGITS)
    if alt_one:
        result = result.replace("一", "幺")
    return result


def _verbalize_under_10000(value: int) -> str:
    """Verbalize 0..9999 with 千/百/十 units, inserting 零 for gaps."""
    if value == 0:
        return "零"
    s = str(value)
    n = len(s)
    out = []
    zero_pending = False
    for idx, ch in enumerate(s):
        d = int(ch)
        place = n - idx  # 4=千, 3=百, 2=十, 1=个
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(DIGITS[ch] + UNITS.get(place, ""))
    return "".join(out)


def verbalize_cardinal(value_string: str) -> str:
    """Verbalize an integer string as a Chinese cardinal with 万/亿 grouping."""
    value_string = value_string.lstrip("0") or "0"
    value = int(value_string)
    if value == 0:
        return "零"
    if len(value_string) > 16:
        # beyond 万亿亿 grouping (1e16) there is no standard spoken
        # unit — read digit-by-digit instead of crashing on the unit
        # table (regression: 17+-digit numbers raised IndexError)
        return verbalize_digit(value_string)
    # Split into 4-digit groups from the right: [..., 亿亿?, 亿, 万, ones]
    groups = []
    while value > 0:
        groups.append(value % 10000)
        value //= 10000
    group_units = ["", "万", "亿", "万亿"]
    out = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = _verbalize_under_10000(g)
        # A group below a non-empty higher group with leading zeros needs 零:
        # e.g. 100000001 -> 一亿零一
        if out and len(str(g)) < 4:
            out.append("零")
        out.append(text + group_units[gi])
    result = "".join(out)
    # Leading 一十X -> 十X (10..19 at the very front).
    if result.startswith("一十"):
        result = result[1:]
    return result


def num2str(value_string: str) -> str:
    """Verbalize a (possibly signed, possibly decimal) number string."""
    value_string = value_string.strip()
    sign = ""
    if value_string.startswith(("-", "−", "负")):
        sign = "负"
        value_string = value_string.lstrip("-−负")
    elif value_string.startswith("+"):
        value_string = value_string[1:]
    if "." in value_string:
        integer, _, fraction = value_string.partition(".")
        fraction = fraction.rstrip("0")
        integer = integer or "0"
        result = verbalize_cardinal(integer)
        if fraction:
            result += "点" + verbalize_digit(fraction)
    else:
        result = verbalize_cardinal(value_string or "0")
    return sign + result


# --- regex replacers used by the normalizer cascade -------------------------

RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
RE_PERCENTAGE = re.compile(r"(-?)(\d+(?:\.\d+)?)%")
RE_INTEGER = re.compile(r"(-)(\d+)")
RE_DECIMAL_NUM = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")
RE_POSITIVE_QUANTIFIERS = re.compile(
    r"(\d+)([多余几\+])?" + COM_QUANTIFIERS
)
RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")
RE_RANGE = re.compile(
    r"((-?)((\d+)(\.\d+)?))[-~]((-?)((\d+)(\.\d+)?))"
)


def replace_frac(match: re.Match) -> str:
    sign = "负" if match.group(1) else ""
    numerator = num2str(match.group(2))
    denominator = num2str(match.group(3))
    return f"{sign}{denominator}分之{numerator}"


def replace_percentage(match: re.Match) -> str:
    sign = "负" if match.group(1) else ""
    return f"{sign}百分之{num2str(match.group(2))}"


def replace_negative_num(match: re.Match) -> str:
    return "负" + num2str(match.group(2))


def replace_default_num(match: re.Match) -> str:
    """Serial-style long digit strings read digit-by-digit (一 -> 幺)."""
    return verbalize_digit(match.group(0), alt_one=True)


def replace_positive_quantifier(match: re.Match) -> str:
    number = match.group(1)
    match_2 = match.group(2) or ""
    match_2 = "多" if match_2 == "+" else match_2
    quantifier = match.group(3)
    return f"{num2str(number)}{match_2}{quantifier}"


def replace_number(match: re.Match) -> str:
    sign = match.group(1)
    number = match.group(2)
    pure_decimal = match.group(5)
    if pure_decimal:
        return num2str(pure_decimal)
    return ("负" if sign else "") + num2str(number)


def replace_range(match: re.Match) -> str:
    first, second = match.group(1), match.group(6)
    first = RE_NUMBER.sub(replace_number, first)
    second = RE_NUMBER.sub(replace_number, second)
    return f"{first}到{second}"
