"""Transformer encoder blocks of the EFTS-Transformer.

Counterpart of `efficient_tts_tpu/nn/transformer.py`: `multi_layered_conv1d`,
`positionwise_ff`, `encoder_layer` and `transformer_block` with
`normalize_before=True` (the only setting the models use). A layer is
x + drop(attn(norm1(x))), then x + drop(ff(norm2(x))); the block ends with
`final_norm`. LayerNorm eps is 1e-12, the conv feed-forward is two 'SAME'
convs without weight norm.

Dropout, in training only (`deterministic=False` and a rate): inside the
feed-forward after its ReLU, on each of the two residual branches, and on
the attention probabilities of the XLA branch. A block takes one CPU
generator per call and splits it per layer, and each layer splits its own
into four (attention, the two residual branches, the feed-forward), as
the JAX block splits its key.

Under sequence parallelism (`sp=`, `parallel/sequence_parallel.py:SeqShard`)
x is the rank's frames: the self-attention takes the whole sequence's keys
and values, the conv feed-forward's 'SAME' convs take halos of the
neighbouring ranks' frames, and every frame dropout takes the rank's window
of the whole sequence's mask; LayerNorm and the position-wise linears stay
on the rank's frames.

Dtypes follow JAX's promotions: the f32 LayerNorm scale turns a bf16 input
into f32, so attention and feed-forward run in f32 and the bf16 residual
plus the f32 branch gives f32.
"""

from __future__ import annotations

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.attention import MultiHeadAttention
from efficient_tts_tpu_torch.nn.layers import Conv1d, LayerNorm, Linear, dropout, split_generator


class MultiLayeredConv1d(nn.Module):
    """conv k -> ReLU -> dropout -> conv k (the FastSpeech FFT block)."""

    def __init__(self, in_ch: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Conv1d(in_ch, hidden, kernel_size)
        self.conv2 = Conv1d(hidden, in_ch, kernel_size)

    def forward(self, x, dropout_rate: float = 0.0, gen=None, deterministic: bool = True, sp=None):
        if sp is None:
            return self.conv2(dropout(torch.relu(self.conv1(x)), dropout_rate, gen, deterministic))
        return sp.conv(self.conv2, sp.dropout(torch.relu(sp.conv(self.conv1, x)), dropout_rate, gen, deterministic))


class PositionwiseFF(nn.Module):
    """linear -> ReLU -> dropout -> linear."""

    def __init__(self, idim: int, hidden: int):
        super().__init__()
        self.w1 = Linear(idim, hidden)
        self.w2 = Linear(hidden, idim)

    def forward(self, x, dropout_rate: float = 0.0, gen=None, deterministic: bool = True, sp=None):
        drop = dropout if sp is None else sp.dropout
        return self.w2(drop(torch.relu(self.w1(x)), dropout_rate, gen, deterministic))


class EncoderLayer(nn.Module):
    def __init__(self, n_feat: int, n_head: int, ff_hidden: int, use_conv_ff: bool = True,
                 kernel_size: int = 3):
        super().__init__()
        self.self_attn = MultiHeadAttention(n_feat, n_head)
        self.ff = (MultiLayeredConv1d(n_feat, ff_hidden, kernel_size) if use_conv_ff
                   else PositionwiseFF(n_feat, ff_hidden))
        self.norm1 = LayerNorm(n_feat)
        self.norm2 = LayerNorm(n_feat)

    def forward(self, x, mask=None, attn_impl: str = "xla", dropout_rate: float = 0.0, gen=None,
                deterministic: bool = True, sp=None):
        train = not deterministic and dropout_rate > 0
        r1, r2, r3, r4 = split_generator(gen, 4) if train else (None,) * 4
        drop = dropout if sp is None else sp.dropout
        h = self.self_attn(self.norm1(x), mask, attn_impl, dropout_rate, r1, deterministic, sp=sp)
        x = x + drop(h, dropout_rate, r2, deterministic)
        h = self.ff(self.norm2(x), dropout_rate, r3, deterministic, sp=sp)
        return x + drop(h, dropout_rate, r4, deterministic)


class TransformerBlock(nn.Module):
    def __init__(self, num_layers: int, n_feat: int, n_head: int, ff_hidden: int,
                 use_conv_ff: bool = True, kernel_size: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(n_feat, n_head, ff_hidden, use_conv_ff, kernel_size) for _ in range(num_layers))
        self.final_norm = LayerNorm(n_feat)

    def forward(self, x, mask=None, attn_impl: str = "xla", dropout_rate: float = 0.0, gen=None,
                deterministic: bool = True, sp=None):
        """x [B, T, D], mask [B, 1, T] True = valid or None -> [B, T, D];
        with `sp` x is the rank's frames [B, T / m, D] and mask the whole
        sequence's."""
        train = not deterministic and dropout_rate > 0
        gens = split_generator(gen, len(self.layers)) if train else [None] * len(self.layers)
        for layer, g in zip(self.layers, gens):
            x = layer(x, mask, attn_impl, dropout_rate, g, deterministic, sp=sp)
        return self.final_norm(x)
