"""Length masks and shape buckets (counterpart of `efficient_tts_tpu/utils/masks.py`)."""

from __future__ import annotations

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
