"""ARPAbet phone inventory and CMU pronouncing dictionary reader.

Copy of `efficient_tts_tpu/text/arpabet.py`, the counterpart of the
reference's `nntts/text/cmudict.py`. The phone set is
the standard CMUdict inventory (39 phones, vowels carrying 0/1/2 stress
markers), ordered alphabetically as in the upstream tacotron frontend so
symbol ids line up with reference checkpoints.
"""

from __future__ import annotations

import re

_STRESSED_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
]
_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N",
    "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

# Alphabetical interleaving of base phones and their stress variants,
# e.g. AA, AA0, AA1, AA2, AE, ... — identical ordering to the reference.
VALID_ARPABET = sorted(
    [v + s for v in _STRESSED_VOWELS for s in ("", "0", "1", "2")] + _CONSONANTS
)

_VALID_SET = frozenset(VALID_ARPABET)

_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word -> list of ARPAbet pronunciations, parsed from a cmudict file."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str):
        return self._entries.get(word.upper())


def _parse(file) -> dict:
    out: dict = {}
    for line in file:
        if not line:
            continue
        c = line[0]
        if not ("A" <= c <= "Z" or c == "'"):
            continue
        parts = line.split("  ")
        if len(parts) < 2:
            continue
        word = _alt_re.sub("", parts[0])
        phones = parts[1].strip().split(" ")
        if any(p not in _VALID_SET for p in phones):
            continue
        out.setdefault(word, []).append(" ".join(phones))
    return out
