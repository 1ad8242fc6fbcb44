"""Batch collation with static-shape bucketing.

Counterpart of `efficient_tts_tpu/data/collate.py:collate_text_mel`,
copied: sort by text length, descending, and zero-pad text and mel, the
padded lengths rounded up to bucket multiples, so the train step sees a
small set of shapes (the cuDNN plans and the flash kernel's T % 128 rule
depend on them). `collate_mel_audio` stacks the vocoder's fixed-size
segments. The other collates (durations, DurationModel) wait for the
modules that use them.
"""

from __future__ import annotations

import numpy as np

from efficient_tts_tpu_torch.utils.masks import round_up


def collate_text_mel(
    batch: list,
    text_bucket: int = 16,
    mel_bucket: int = 64,
    fixed_text_len: int | None = None,
    fixed_mel_len: int | None = None,
    sort: bool = True,
) -> dict:
    """[(text ids [T1], mel [T2, n_mels])] -> {text [B, T1] int32,
    text_lengths [B] int32, mel [B, T2, n_mels] f32, mel_lengths [B] int32}.

    With `fixed_*_len` the batch pads to exactly those lengths; otherwise
    lengths round up to the bucket multiple. `sort=False` keeps the input
    order (rows that map back to utterance ids)."""
    if sort:
        order = np.argsort([-len(x[0]) for x in batch], kind="stable")
        batch = [batch[i] for i in order]

    text_lengths = np.asarray([len(x[0]) for x in batch], np.int32)
    mel_lengths = np.asarray([x[1].shape[0] for x in batch], np.int32)
    n_mels = batch[0][1].shape[1]

    t1 = fixed_text_len or round_up(int(text_lengths.max()), text_bucket)
    t2 = fixed_mel_len or round_up(int(mel_lengths.max()), mel_bucket)
    if int(text_lengths.max()) > t1 or int(mel_lengths.max()) > t2:
        raise ValueError("fixed length smaller than batch max")

    b = len(batch)
    text = np.zeros((b, t1), np.int32)
    mel = np.zeros((b, t2, n_mels), np.float32)
    for i, (t, m) in enumerate(batch):
        text[i, : len(t)] = t
        mel[i, : m.shape[0]] = m
    return {"text": text, "text_lengths": text_lengths, "mel": mel, "mel_lengths": mel_lengths}


def collate_mel_audio(batch: list) -> dict:
    """[(mel [F, M], audio [S], mel_loss [F, M])] -> {mel [B, F, M], audio
    [B, S], mel_loss [B, F, M]}, f32 (every segment has the same size)."""
    return {
        "mel": np.stack([x[0] for x in batch]).astype(np.float32),
        "audio": np.stack([x[1] for x in batch]).astype(np.float32),
        "mel_loss": np.stack([x[2] for x in batch]).astype(np.float32),
    }
