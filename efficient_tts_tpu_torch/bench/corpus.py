"""A seeded synthetic speech corpus in LJSpeech's layout, for training runs without data.

    make_corpus(root, n_train=384, n_dev=16, seed=0)

writes `root/wavs/<id>.wav` (PCM_16, 22050 Hz, mono) and the filelists
`root/train.txt` and `root/dev.txt`, lines of `wavs/<id>.wav|<text>`.
Durations span LJSpeech's range, 1.5-10 s, from a beta distribution of mean
about 6.5 s. Each utterance is a harmonic tone (8 partials, 1/h
amplitudes) on a seeded f0 contour (a base of 90-220 Hz with vibrato and a
slow drift), under a syllable-rate envelope, plus noise; its text is words
of a fixed list drawn at about 15 characters a second, as read speech has.
Everything follows from the seed.
"""

from __future__ import annotations

import os

import numpy as np

SAMPLE_RATE = 22050
MIN_S, MAX_S, MEAN_S = 1.5, 10.0, 6.5
CHARS_PER_S = 15.0
WORDS = (
    "the of and to in that was he his it with as had for at by on not be which from this but were "
    "all she they her been have one when an so there their would said who we more into time some "
    "then could them about after made any upon other only like over such these must very before "
    "great little first those prisoner house evidence witness morning street letter court money"
).split()


def utterance(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """One synthetic utterance of `seconds`, float32 in [-0.6, 0.6]."""
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(90.0, 220.0) * (1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
                                     + 0.15 * np.sin(2 * np.pi * rng.uniform(0.1, 0.4) * t + rng.uniform(0, 6.3)))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    y = sum(np.sin(h * phase + rng.uniform(0, 6.3)) / h for h in range(1, 9))
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6.3))
    y = y * envelope + 0.02 * rng.standard_normal(n)
    return (0.6 * y / np.abs(y).max()).astype(np.float32)


def sentence(rng: np.random.Generator, seconds: float) -> str:
    """Words of `WORDS` up to about CHARS_PER_S characters a second."""
    target = max(int(CHARS_PER_S * seconds), 8)
    words = []
    while sum(len(w) + 1 for w in words) < target:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    text = " ".join(words)
    return text[0].upper() + text[1:] + "."


def make_corpus(root: str, n_train: int = 384, n_dev: int = 16, seed: int = 0, min_s: float = MIN_S,
                max_s: float = MAX_S) -> dict:
    """Write the corpus under `root`; {"train", "dev": filelist paths, "wavs":
    the wav directory, "seconds": the durations}."""
    from scipy.io.wavfile import write

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    # a beta of mean (MEAN_S - MIN_S) / (MAX_S - MIN_S) over [min_s, max_s]
    a = 4.0 * (MEAN_S - MIN_S) / (MAX_S - MIN_S)
    seconds = min_s + (max_s - min_s) * rng.beta(a, 4.0 - a, n_train + n_dev)
    lines = []
    for i, s in enumerate(seconds):
        name = f"SYN{seed:03d}-{i:04d}"
        pcm = np.round(utterance(rng, s) * 32767).astype(np.int16)
        write(os.path.join(wav_dir, name + ".wav"), SAMPLE_RATE, pcm)
        lines.append(f"wavs/{name}.wav|{sentence(rng, s)}\n")
    paths = {"train": os.path.join(root, "train.txt"), "dev": os.path.join(root, "dev.txt"), "wavs": wav_dir,
             "seconds": seconds}
    with open(paths["train"], "w", encoding="utf-8") as f:
        f.writelines(lines[:n_train])
    with open(paths["dev"], "w", encoding="utf-8") as f:
        f.writelines(lines[n_train:])
    return paths
