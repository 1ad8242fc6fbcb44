"""Text frontend: string -> symbol-id sequences.

Copy of `efficient_tts_tpu/text/__init__.py` (ids must be identical: they
index the embedding), the counterpart of the reference's
`nntts/text/__init__.py` with the same
public surface (`text_to_sequence` / `sequence_to_text`, `{ARPAbet}`
curly-brace support) plus a phone-set vocabulary loader for the
phone-sequence input mode used by the LJ recipe
(`taco2_data.py:37-42`: whitespace-split phones mapped by a vocab file).
"""

from __future__ import annotations

import re

from efficient_tts_tpu_torch.text import cleaners as _cleaners_mod
from efficient_tts_tpu_torch.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names=("english_cleaners",)) -> list:
    """Text -> list of symbol ids; `{HH AW1 S}` spans read as ARPAbet."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence) -> str:
    result = ""
    for symbol_id in sequence:
        s = _id_to_symbol.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        result += s
    return result.replace("}{", " ")


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms):
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in _symbol_to_id and s != "_" and s != "~"


def load_phone_vocab(path: str) -> dict:
    """Phone-set file (one phone per line) -> {phone: id}.

    The LJ recipe's phone-sequence mode (`taco2_data.py:40-42`): ids are
    line order, 0-based (LJ set: 76 phones, ids 0..75, matching the
    config's num_symbols: 76). NOTE: id 0 collides with the pad id -- a
    latent quirk of the reference preserved deliberately for checkpoint
    parity (SURVEY.md §2.6).
    """
    with open(path, "r") as f:
        phones = [line.strip() for line in f if line.strip()]
    return {p: i for i, p in enumerate(phones)}


def phones_to_sequence(text: str, phone_vocab: dict) -> list:
    """Whitespace-separated phone string -> ids (`taco2_data.py:80-84`)."""
    return [phone_vocab[p] for p in text.split()]
