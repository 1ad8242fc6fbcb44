"""English number normalization for the text frontend.

Copy of `efficient_tts_tpu/text/numbers_en.py`, the behavioral counterpart
of the reference's `nntts/text/numbers.py`, which delegates to the
`inflect` package. The package does not depend on `inflect`, so the
small subset actually exercised by the frontend -- cardinals with scale
commas, ordinals, 4-digit year pairs (group=2) with "oh" for 0x pairs --
is implemented natively.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion",
]
_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _under_1000(n: int, andword: str) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_under_100(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and", zero: str = "zero", group: int = 0) -> str:
    """Cardinal words for a non-negative integer.

    Mirrors the `inflect.number_to_words` behavior the reference relies on:
    scale groups joined with ", " (e.g. "one thousand, two hundred"),
    optional "and" inside hundreds, and `group=2` pair reading for years
    ("nineteen, ninety-nine").
    """
    n = int(n)
    if n == 0:
        return zero
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        pairs = [int(digits[i : i + 2]) for i in range(0, len(digits), 2)]
        words = []
        for p in pairs:
            if p == 0:
                words.append(zero * 2 if zero == "o" else zero)
            elif p < 10:
                words.append(f"{zero} {_ONES[p]}")
            else:
                words.append(_under_100(p))
        return ", ".join(words)

    groups = []
    scale = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            text = _under_1000(chunk, andword if scale == 0 else "")
            if scale:
                text += " " + _SCALES[scale]
            groups.append(text)
        scale += 1
    return ", ".join(reversed(groups))


def ordinal_words(n: int, andword: str = "and") -> str:
    """Ordinal words: 21 -> "twenty-first", 100 -> "one hundredth"."""
    cardinal = number_to_words(n, andword=andword)
    # Transform the final word into its ordinal form.
    head, _, last = cardinal.rpartition(" ")
    if "-" in last:
        h2, _, l2 = last.rpartition("-")
        last_ord = h2 + "-" + _ordinalize_word(l2)
    else:
        last_ord = _ordinalize_word(last)
    return (head + " " + last_ord).strip()


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    return w + "th"


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
