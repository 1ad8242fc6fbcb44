"""Log-domain duration MSE (counterpart of `efficient_tts_tpu/losses/duration.py`), the DurationModel's loss."""

from __future__ import annotations

import torch


def duration_mse_loss(outputs: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                      offset: float = 1.0) -> torch.Tensor:
    """MSE(outputs, log(targets + offset)) over the valid positions: outputs
    are log-domain predictions [B, T], targets linear-domain durations [B,
    T], mask [B, T] true on valid steps; the sum over at least 1."""
    err = torch.square(outputs - torch.log(targets.float() + offset))
    maskf = mask.to(err.dtype)
    return torch.sum(err * maskf) / torch.clamp(torch.sum(maskf), min=1.0)
