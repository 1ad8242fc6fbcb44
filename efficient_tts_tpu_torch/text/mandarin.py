"""Mandarin (DataBaker) front-end: pinyin -> phone/tone token sequences.

Copy of `efficient_tts_tpu/text/mandarin.py`, the counterpart of the
reference's DataBaker preprocessing
(`egs/lj/local/preprocess_scripts/text/parse_pronounce.py`):
initial/final pinyin splitting with tone separation (:42-65), functional
punctuation and prosody-boundary token maps (:14-36), and sentence
assembly with _HEAD/_TAIL and end-of-sentence punctuation promotion
(:141-163). The DataBaker recipe itself trains with "exactly the same
setting as LJSpeech" and the shared LJ vocoder (reference README.md:7) --
only the phone inventory differs (cn_phn_set_from_txdata.txt).
"""

from __future__ import annotations

MANDARIN_INITIALS = [
    "b", "ch", "c", "d", "f", "g", "h", "j", "k", "l",
    "m", "n", "p", "q", "r", "sh", "s", "t", "x", "zh", "z",
]

PUNC_MAP = {
    "_FH": "_FH",
    "_MH": "_MH",
    "_DUN": "_DUN",
    "_DH": "_DH",
    "_WH": "_WH",
    "_TH": "_TH",
    "_DYH": "_OPUNC",
    "_KH": "_OPUNC",
    "_PZH": "_OPUNC",
    "_SLH": "_OPUNC",
    "_SMH": "_OPUNC",
    "_SYH": "_OPUNC",
    "_YD": "_OPUNC",
}

FINAL_PUNC_MAP = {
    "_DH_E": "_JH_E",
    "_JH": "_DH",
    "_OPUNC_E": "_JH_E",
}


def split_phone_tone(s: str) -> list:
    """'ang3' -> ['ang', '3']; toneless tokens pass through."""
    head = s.rstrip("0123456")
    if len(head) == len(s):
        return [s]
    return [head, s[len(head):]]


def split_initial_final(syllable: str) -> list:
    """Raw pinyin syllable -> [initial, final] (longest-initial match);
    zero-initial syllables return [final]."""
    for init in sorted(MANDARIN_INITIALS, key=len, reverse=True):
        if syllable.startswith(init) and len(syllable) > len(init):
            return [init, syllable[len(init):]]
    return [syllable]


def parse_pinyin_phn_tone_sep(py: str) -> list:
    """'-'-separated phones, tone split into its own token (PHN_TONE_SEP)."""
    out = []
    for phn in py.split("-"):
        out.extend(split_phone_tone(phn))
    return out


def parse_pinyin_phn_tone(py: str) -> list:
    """'-'-separated phones with tone kept attached (PHN_TONE)."""
    return [p for p in py.split("-") if p]


PARSE_PINYIN_METHODS = {
    "PHN_TONE_SEP": parse_pinyin_phn_tone_sep,
    "PHN_TONE": parse_pinyin_phn_tone,
}


def parse_pinyin(pronoun_line: str, py_type: str) -> list:
    """Pronunciation line -> phone tokens, each syllable preceded by
    _SPS_SEG (:88-100)."""
    parts = pronoun_line.split()
    pinyins = [py for py in parts[-1].split("|") if py]
    method = PARSE_PINYIN_METHODS.get(py_type)
    if method is None:
        raise ValueError(f"parse_pinyin for [{py_type}] is not implemented")
    out = []
    for py in pinyins:
        out.append("_SPS_SEG")
        out.extend(method(py))
    return out


def parse_punct(pronoun_line: str) -> list:
    """Prosody-boundary + punctuation suffix tokens (:103-117)."""
    parts = pronoun_line.split()
    punct_part = parts[3]
    seg_sign = parts[-2]
    if seg_sign == "#0":
        return []
    if punct_part != "0":
        punc = "_" + punct_part.upper()
        punc = PUNC_MAP.get(punc, punc)
        return ["_WORD_SEG" + seg_sign, punc]
    return ["_WORD_SEG" + seg_sign]


def parse_line(pronoun_line: str, py_type: str) -> list:
    return parse_pinyin(pronoun_line, py_type) + parse_punct(pronoun_line)


def parse_sent(
    pronoun_lines: list,
    py_type: str = "PHN_TONE_SEP",
    use_head: bool = True,
    use_tail: bool = True,
) -> list:
    """Sentence assembly with head/tail markers and sentence-final
    punctuation promotion (`_X` -> `_X_E`, then FINAL_PUNC_MAP) (:141-163)."""
    out = ["_HEAD"] if use_head else []
    for idx, line in enumerate(pronoun_lines):
        if not line or line.startswith("#") or line.startswith("["):
            continue
        tokens = parse_line(line, py_type)
        if idx == len(pronoun_lines) - 1 and tokens and tokens[-1].startswith("_"):
            tokens[-1] += "_E"
        out.extend(tokens)
    out = [FINAL_PUNC_MAP.get(t, t) for t in out]
    if use_tail:
        out.append("_TAIL")
    return out
