"""FastSpeech-style duration predictor.

Counterpart of `efficient_tts_tpu/nn/duration_predictor.py`: `_backbone`,
`duration_predictor` (training) and `duration_predictor_infer`. n_layers x
(conv k3 -> ReLU -> LayerNorm -> dropout) -> linear -> 1. Training returns
log-domain durations with pads set to 0; inference clamp(exp(d) - offset,
0) with pads zeroed.
"""

from __future__ import annotations

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear, dropout, split_generator


class DurationPredictor(nn.Module):
    def __init__(self, n_chans: int, n_layers: int = 2, kernel_size: int = 3):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(n_chans, n_chans, kernel_size) for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(n_chans) for _ in range(n_layers))
        self.out = Linear(n_chans, 1)

    def backbone(self, x: torch.Tensor, dropout_rate: float = 0.0, gen=None,
                 deterministic: bool = True) -> torch.Tensor:
        """[B, T, C] -> log-domain durations [B, T]; one dropout per layer."""
        train = not deterministic and dropout_rate > 0
        gens = split_generator(gen, len(self.convs)) if train else [None] * len(self.convs)
        for conv, norm, g in zip(self.convs, self.norms, gens):
            x = dropout(norm(torch.relu(conv(x))), dropout_rate, g, deterministic)
        return self.out(x)[..., 0]

    def forward(self, x, pad_mask=None, dropout_rate: float = 0.0, gen=None, deterministic: bool = True):
        """Training: log-domain durations [B, T], pads (pad_mask True) -> 0."""
        d = self.backbone(x, dropout_rate, gen, deterministic)
        if pad_mask is not None:
            d = torch.where(pad_mask, torch.zeros((), dtype=d.dtype, device=d.device), d)
        return d

    def infer(self, x, pad_mask=None, offset: float = 1.0):
        """Linear-domain durations clamp(exp(d) - offset, 0), unrounded; pads -> 0."""
        d = torch.clamp(torch.exp(self.backbone(x)) - offset, min=0.0)
        if pad_mask is not None:
            d = torch.where(pad_mask, torch.zeros_like(d), d)
        return d
