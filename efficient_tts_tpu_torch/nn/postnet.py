"""Tacotron 2's postnet (counterpart of `efficient_tts_tpu/nn/postnet.py`).

Five convs (k 5; odim -> n_chans -> ... -> odim), each followed by batch
norm and, but for the last, tanh, then dropout: a residual refinement of a
mel prediction. Batch norm is JAX's functional form: it always normalizes
by its stored `mean` and `var` (buffers, eps 1e-5), then scales and
shifts; it computes no batch statistics and updates nothing, unlike
`nn.BatchNorm1d` in training mode. Nothing in the JAX package calls it.
"""

from __future__ import annotations

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, dropout, frozen_param, split_generator


class BatchNormState(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = frozen_param((dim,))
        self.bias = frozen_param((dim,))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return (x - self.mean) * torch.rsqrt(self.var + eps) * self.scale + self.bias


class Postnet(nn.Module):
    def __init__(self, odim: int = 80, n_layers: int = 5, n_chans: int = 512, n_filts: int = 5):
        super().__init__()
        chans = [odim] + [n_chans] * (n_layers - 1) + [odim]
        self.convs = nn.ModuleList(Conv1d(chans[i], chans[i + 1], n_filts) for i in range(n_layers))
        self.norms = nn.ModuleList(BatchNormState(chans[i + 1]) for i in range(n_layers))

    def forward(self, x: torch.Tensor, dropout_rate: float = 0.5, gen=None, deterministic: bool = True):
        """x [B, T, odim] -> [B, T, odim]; one dropout generator per layer."""
        train = not deterministic and dropout_rate > 0
        gens = split_generator(gen, len(self.convs)) if train else [None] * len(self.convs)
        for i, (conv, norm, g) in enumerate(zip(self.convs, self.norms, gens)):
            x = norm(conv(x))
            if i != len(self.convs) - 1:
                x = torch.tanh(x)
            x = dropout(x, dropout_rate, g, deterministic)
        return x
