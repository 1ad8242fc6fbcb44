"""Seeded utterance sizes and sentences, the benchmark's own copy of the corpus's draw.

Durations follow the synthetic corpus's beta distribution over LJSpeech's
range, 1.5-10 s with a mean of about 6.5 s. So that the seed does not change
the work, a plan takes the distribution's quantiles at (i + 0.5) / n, not
random draws, and shuffles them with the traffic file's own `plan_seed`:
every run seed sees the same sizes in the same order. The run seed draws
only what the sizes leave free: the words of each sentence, the ids and
targets of a training batch, the weights.

A sentence is words of a fixed list with exactly the number of characters
asked for, ending in a period, so its encoded length is that number.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 22050
HOP = 256
MIN_S, MAX_S, MEAN_S = 1.5, 10.0, 6.5
WORDS = (
    "the of and to in that was he his it with as had for at by on not be which from this but were "
    "all she they her been have one when an so there their would said who we more into time some "
    "then could them about after made any upon other only like over such these must very before "
    "great little first those prisoner house evidence witness morning street letter court money a"
).split()
_BY_LENGTH: dict[int, list[str]] = {}
for _w in WORDS:
    _BY_LENGTH.setdefault(len(_w), []).append(_w)
_LONGEST = max(_BY_LENGTH)


def beta_quantiles(n: int, min_s: float = MIN_S, max_s: float = MAX_S, mean_s: float = MEAN_S) -> np.ndarray:
    """n durations in seconds at the quantiles (i + 0.5) / n of the corpus's
    beta of mean `mean_s` over [min_s, max_s] (shape a, 4 - a)."""
    from scipy.stats import beta

    a = 4.0 * (mean_s - min_s) / (max_s - min_s)
    return min_s + (max_s - min_s) * beta.ppf((np.arange(n) + 0.5) / n, a, 4.0 - a)


def exponential_quantiles(n: int, mean: float) -> np.ndarray:
    """n gaps at the quantiles (i + 0.5) / n of an exponential of `mean`."""
    return -mean * np.log(1.0 - (np.arange(n) + 0.5) / n)


def planned(values: np.ndarray, plan_seed: int) -> np.ndarray:
    """`values` in the fixed order of `plan_seed`."""
    return values[np.random.default_rng(plan_seed).permutation(len(values))]


def frames(seconds) -> np.ndarray:
    """Mel frames of `seconds` of audio, at least 1."""
    return np.maximum(np.round(np.asarray(seconds) * SAMPLE_RATE / HOP), 1).astype(np.int64)


def sentence(rng: np.random.Generator, n_chars: int) -> str:
    """Words of `WORDS`, capitalized, ending in a period, exactly `n_chars`
    characters long (at least 2)."""
    if n_chars < 2:
        raise ValueError(f"a sentence takes at least 2 characters, asked for {n_chars}")
    left = n_chars - 1  # the period
    words = []
    while left > _LONGEST + 1:
        w = WORDS[int(rng.integers(len(WORDS)))]
        words.append(w)
        left -= len(w) + 1
    # 1 <= left <= _LONGEST + 1 here: one last word, or "a" and one more
    if left not in _BY_LENGTH:
        words.append("a")
        left -= 2
    choices = _BY_LENGTH[left]
    words.append(choices[int(rng.integers(len(choices)))])
    text = " ".join(words) + "."
    return text[0].upper() + text[1:]
