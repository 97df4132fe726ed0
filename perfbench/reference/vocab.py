"""The phoneme vocabulary the served model reads: one id per IPA character,
id 0 for padding and for the start and end of an utterance. Frozen here so
that the reference encodes text without the program's tables."""
from __future__ import annotations

from typing import List

# id i is SYMBOLS[i]
SYMBOLS = ('$;:,.!?—…"()“”/ \'-aefijklmnopstuwxyŋɕəɚɛɤɥɨʂʈʊʐʰ→↓↗↘ɑæʌɔɪɝʃʒθðɹ'
           'bdɡhvzˈˌːɒɜ❓&@#%+=*~^|<>[]{}')
IDS = {s: i for i, s in enumerate(SYMBOLS)}


def encode(ipa: str) -> List[int]:
    """IPA -> [0] + ids + [0]; characters outside the vocabulary drop."""
    return [0] + [IDS[c] for c in ipa if c in IDS] + [0]
