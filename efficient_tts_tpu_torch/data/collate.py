"""Batch collation with static-shape bucketing.

Counterpart of `efficient_tts_tpu/data/collate.py:collate_text_mel`,
copied: sort by text length, descending, and zero-pad text and mel, the
padded lengths rounded up to bucket multiples, so the train step sees a
small set of shapes (the cuDNN plans and the flash kernel's T % 128 rule
depend on them). `collate_mel_audio` stacks the vocoder's fixed-size
segments. `collate_text_mel_durations` (TTSCollate: external durations,
the last real duration of a row bumped so the row sums to its mel length)
and `collate_duration_model` (the DurationModel's PPG batches) are copied
too.
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


def collate_text_mel_durations(batch: list, text_bucket: int = 16, mel_bucket: int = 64,
                               n_frames_per_step: int = 1) -> dict:
    """[(text [T1], durations [T1], mel [T2, M], spkid)] -> padded dict. The
    durations are zero-padded to T1, and a row whose durations fall short
    of its mel length has its last real duration bumped to close the gap,
    so the duration-expanded decoder stays aligned with the padded mel. A
    batch's longest mel length is rounded up to n_frames_per_step."""
    text_lengths = np.asarray([len(x[0]) for x in batch], np.int32)
    mel_lengths = np.asarray([x[2].shape[0] for x in batch], np.int32)
    n_mels = batch[0][2].shape[1]

    t1 = round_up(int(text_lengths.max()), text_bucket)
    t2_real = int(mel_lengths.max())
    if t2_real % n_frames_per_step:
        t2_real += n_frames_per_step - t2_real % n_frames_per_step
        mel_lengths[int(np.argmax(mel_lengths))] = t2_real
    t2 = round_up(t2_real, mel_bucket)

    b = len(batch)
    text = np.zeros((b, t1), np.int32)
    durations = np.zeros((b, t1), np.int32)
    mel = np.zeros((b, t2, n_mels), np.float32)
    spkids = np.zeros((b,), np.int32)
    for i, (t, dur, m, spk) in enumerate(batch):
        text[i, : len(t)] = t
        d = np.asarray(dur, np.int64).copy()
        short = int(mel_lengths[i]) - int(d.sum())
        if short > 0:
            d[-1] += short
        durations[i, : len(d)] = d
        mel[i, : m.shape[0]] = m
        spkids[i] = int(spk)
    return {"text": text, "text_lengths": text_lengths, "durations": durations, "mel": mel,
            "mel_lengths": mel_lengths, "spkids": spkids}


def collate_duration_model(batch: list, bucket: int = 16) -> dict:
    """[(ppg [T, D], durations [T], spkid)] -> {"ppg" [B, T', D], "lengths",
    "durations" [B, T'], "spkids"}, T' the longest T rounded up to `bucket`."""
    lengths = np.asarray([x[0].shape[0] for x in batch], np.int32)
    t = round_up(int(lengths.max()), bucket)
    b = len(batch)
    ppg = np.zeros((b, t, batch[0][0].shape[1]), np.float32)
    durations = np.zeros((b, t), np.int32)
    spkids = np.zeros((b,), np.int32)
    for i, (p, dur, spk) in enumerate(batch):
        n = p.shape[0]
        ppg[i, :n] = p
        durations[i, :n] = np.asarray(dur)[:n]
        spkids[i] = int(spk)
    return {"ppg": ppg, "lengths": lengths, "durations": durations, "spkids": spkids}


def collate_mel_audio(batch: list) -> dict:
    """[(mel [F, M], audio [S], mel_loss [F, M])] -> {mel [B, F, M], audio
    [B, S], mel_loss [B, F, M]}, f32 (every segment has the same size)."""
    return {
        "mel": np.stack([x[0] for x in batch]).astype(np.float32),
        "audio": np.stack([x[1] for x in batch]).astype(np.float32),
        "mel_loss": np.stack([x[2] for x in batch]).astype(np.float32),
    }
