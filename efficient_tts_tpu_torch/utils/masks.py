"""Length masks, shape buckets and host-side padding (counterpart of `efficient_tts_tpu/utils/masks.py`)."""

from __future__ import annotations

import numpy as np
import torch


def sequence_mask(lengths: torch.Tensor, max_len: int, dtype=torch.bool) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask, True on valid (non-pad) steps."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def bucket_length(length: int, multiple: int = 32, min_len: int = 32) -> int:
    """Round a mel length up to a static bucket (at least `min_len`)."""
    return max(min_len, round_up(int(length), multiple))


def pad_list(xs, pad_value=0) -> np.ndarray:
    """Host-side: stack variable-length numpy arrays, right-padded along
    the first axis."""
    xs = [np.asarray(x) for x in xs]
    max_len = max(x.shape[0] for x in xs)
    return np.stack([np.pad(x, [(0, max_len - x.shape[0])] + [(0, 0)] * (x.ndim - 1), constant_values=pad_value)
                     for x in xs])
