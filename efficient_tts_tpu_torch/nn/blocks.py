"""Residual conv block of EFTS-CNN (counterpart of `efficient_tts_tpu/nn/blocks.py`).

Inference only: each layer is x + leaky_relu(conv_k(x)), no dropout.
"""

from __future__ import annotations

from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, leaky_relu


class ResConvBlock(nn.Module):
    def __init__(self, num_layers: int, n_channels: int, k_size: int, negative_slope: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(Conv1d(n_channels, n_channels, k_size) for _ in range(num_layers))
        self.negative_slope = negative_slope

    def forward(self, x):
        """[B, T, C] -> [B, T, C]."""
        for conv in self.layers:
            x = x + leaky_relu(conv(x), self.negative_slope)
        return x
