# -*- coding: utf-8 -*-
"""Arabic-numeral -> Chinese pre-pass for G2P.

Plays the role of ``cn2an.transform(text, 'an2cn')`` used by the reference
(reference: src/illufly_tts/core/g2p/chinese_g2p.py:126). Normalization
upstream already verbalizes most NSWs; this is the safety net for stray
digits reaching G2P.
"""
from __future__ import annotations

import re

from ..normalization.zh.num import num2str, verbalize_digit

_RE_NUM = re.compile(r"\d+(?:\.\d+)?")


def an2cn(text: str) -> str:
    def repl(match: re.Match) -> str:
        s = match.group(0)
        if "." not in s and len(s) > 8:
            return verbalize_digit(s)  # long serials digit-by-digit
        return num2str(s)

    return _RE_NUM.sub(repl, text)
