"""FastSpeech-style duration predictor, inference path.

Counterpart of `efficient_tts_tpu/nn/duration_predictor.py:_backbone` and
`duration_predictor_infer`: n_layers x (conv k3 -> ReLU -> LayerNorm) ->
linear -> 1, then clamp(exp(d) - offset, 0) with pads zeroed.
"""

from __future__ import annotations

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear


class DurationPredictor(nn.Module):
    def __init__(self, n_chans: int, n_layers: int = 2, kernel_size: int = 3):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(n_chans, n_chans, kernel_size) for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(n_chans) for _ in range(n_layers))
        self.out = Linear(n_chans, 1)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> log-domain durations [B, T]."""
        for conv, norm in zip(self.convs, self.norms):
            x = norm(torch.relu(conv(x)))
        return self.out(x)[..., 0]

    def infer(self, x, pad_mask=None, offset: float = 1.0):
        """Linear-domain durations clamp(exp(d) - offset, 0), unrounded; pads -> 0."""
        d = torch.clamp(torch.exp(self.backbone(x)) - offset, min=0.0)
        if pad_mask is not None:
            d = torch.where(pad_mask, torch.zeros_like(d), d)
        return d
