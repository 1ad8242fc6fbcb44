"""Residual conv block of EFTS-CNN (counterpart of `efficient_tts_tpu/nn/blocks.py`).

Each layer is x + dropout(leaky_relu(conv_k(x))), one dropout generator per
layer. With `weight_norm` the convs keep trainable {v, g} (`WNConv1d`), as
a training model holds them; `fold` turns them into the plain convs of
inference.
"""

from __future__ import annotations

from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, WNConv1d, dropout, leaky_relu, split_generator


class ResConvBlock(nn.Module):
    def __init__(self, num_layers: int, n_channels: int, k_size: int, negative_slope: float = 0.1,
                 weight_norm: bool = False):
        super().__init__()
        conv = WNConv1d if weight_norm else Conv1d
        self.layers = nn.ModuleList(conv(n_channels, n_channels, k_size) for _ in range(num_layers))
        self.negative_slope = negative_slope

    def forward(self, x, dropout_rate: float = 0.0, gen=None, deterministic: bool = True, sp=None):
        """[B, T, C] -> [B, T, C]; with `deterministic=False` and a rate,
        `gen` (a CPU generator) drives each layer's dropout. With `sp` (a
        `parallel/sequence_parallel.py:SeqShard`) x is the rank's frames and
        each conv takes its neighbours' halo."""
        train = not deterministic and dropout_rate > 0
        gens = split_generator(gen, len(self.layers)) if train else [None] * len(self.layers)
        for conv, g in zip(self.layers, gens):
            if sp is None:
                x = x + dropout(leaky_relu(conv(x), self.negative_slope), dropout_rate, g, deterministic)
            else:
                x = x + sp.dropout(leaky_relu(sp.conv(conv, x), self.negative_slope), dropout_rate, g,
                                   deterministic)
        return x

    def fold(self) -> None:
        """Replace each weight-normed conv by its plain fold, in place."""
        for i, conv in enumerate(self.layers):
            if isinstance(conv, WNConv1d):
                self.layers[i] = conv.fold()
