"""Host-side filelists (counterpart of `efficient_tts_tpu/data/dataset.py`).

Only the filelist reader the inference CLI needs so far: lines of
`wavpath|text`, blank lines skipped.
"""

from __future__ import annotations


def load_filepaths_and_text(filename: str, split: str = "|") -> list:
    with open(filename, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]
