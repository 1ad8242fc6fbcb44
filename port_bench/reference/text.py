"""Text to symbol ids for the sentences the benchmark writes.

The character inventory of the EFTS-CNN recipe (`lj_efts_cnn_char.yaml`,
148 symbols: pad, "-", punctuation, the ASCII letters, then ARPAbet) and
its English cleaning, cut to what the benchmark's sentences hold: ASCII
letters, spaces and a period, lowercased, whitespace collapsed. Anything
else raises, so a sentence that would need the full cleaners (numbers,
abbreviations) never reaches this encoder unnoticed.
"""

from __future__ import annotations

import re

SYMBOLS = "_" + "-" + "!'(),.:;? " + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_ID = {s: i for i, s in enumerate(SYMBOLS)}
_PLAIN = re.compile(r"[A-Za-z .]*")


def encode(text: str) -> list[int]:
    if not _PLAIN.fullmatch(text):
        raise ValueError(f"the reference encodes letters, spaces and periods only: {text!r}")
    return [_ID[c] for c in re.sub(r"\s+", " ", text.lower())]
