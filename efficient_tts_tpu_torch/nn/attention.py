"""Multi-head self-attention and sinusoidal positional encodings.

Counterpart of `efficient_tts_tpu/nn/attention.py`: `positional_encoding`,
`add_positional_encoding`, `_flash_eligible` and `multi_head_attention` on
self-attention, inference and training.

Two attention paths with different semantics at padded positions, chosen
call by call as the JAX package chooses them:
  * flash (`impl="flash"`, or `"auto"` on a CUDA tensor), for every call
    that `flash_eligible` admits: the key-padding mask becomes segment ids
    (valid = 1, pad = 0), so pad queries attend only to pad keys. On the
    card this is the Hopper kernels (`ops/flash_attention.py`: the forward
    kernel, and in training the dkv and dq kernels as its backward), on
    the CPU their plain version under autograd;
  * the XLA branch everywhere else: key-padding semantics, where pad
    queries attend to the valid keys and masked weights are zeroed, then
    attention-probability dropout in training. It is plain PyTorch, as JAX
    computes it outside any Pallas kernel.
`impl="flash_plain"` takes the flash path's calls through the kernels'
plain version on any device, so a run on the card can be held against the
same path without the kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Linear, dropout
from efficient_tts_tpu_torch.ops.flash_attention import SegmentIds, flash_attention, flash_attention_reference

IMPLS = ("xla", "flash", "auto", "flash_plain")


def flash_eligible(tq: int, tk: int, mask, dropout_rate: float = 0.0, deterministic: bool = True) -> bool:
    """The flash path takes self-attention with T a multiple of 128, no
    attention-probability dropout and at most a key-padding mask [B, 1, T]."""
    if tq != tk or tq % 128 != 0:
        return False
    if not deterministic and dropout_rate > 0:
        return False
    return mask is None or (mask.dim() == 3 and mask.shape[1] == 1)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_feat: int, n_head: int):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat={n_feat} is not a multiple of n_head={n_head}")
        self.n_head = n_head
        self.q, self.k, self.v, self.out = (Linear(n_feat, n_feat) for _ in range(4))

    def forward(self, x, mask=None, impl: str = "xla", dropout_rate: float = 0.0, gen=None,
                deterministic: bool = True):
        """x [B, T, D] -> [B, T, D]; mask [B, 1|T, T] True = valid. With
        `deterministic=False` and a rate, the XLA branch drops attention
        probabilities with generator `gen` and no call is flash-eligible."""
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}: expected one of {IMPLS}")
        b, t, d = x.shape
        dk = d // self.n_head

        def heads(lin):
            return lin(x).view(b, t, self.n_head, dk).transpose(1, 2)  # [B, H, T, dk]

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        if impl == "auto":
            impl = "flash" if x.device.type == "cuda" else "xla"
        if impl in ("flash", "flash_plain") and flash_eligible(t, t, mask, dropout_rate, deterministic):
            seg = None
            if mask is not None:
                ids = mask[:, 0, :].to(torch.int32).contiguous()
                seg = SegmentIds(ids, ids)
            fn = flash_attention if impl == "flash" else flash_attention_reference
            ctx = fn(q, k, v, seg, sm_scale=1.0 / float(np.sqrt(dk)))
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dk)
            if mask is not None:
                m = mask[:, None, :, :]
                attn = torch.softmax(scores.masked_fill(~m, -1e30), dim=-1).masked_fill(~m, 0.0)
            else:
                attn = torch.softmax(scores, dim=-1)
            attn = dropout(attn, dropout_rate, gen, deterministic)
            ctx = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.out(ctx.transpose(1, 2).reshape(b, t, d))


def positional_encoding(t: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sinusoidal table [T, D], built in float64 and cast once."""
    position = np.arange(t)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2).astype(np.float64) * -(np.log(10000.0) / d))
    pe = np.zeros((t, d))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def add_positional_encoding(x: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, D] + PE in x's dtype; a learnable `scale` (cast to x's
    dtype by the caller) multiplies the table first."""
    pe = positional_encoding(x.shape[1], x.shape[2], x.dtype, x.device)
    if scale is not None:
        pe = pe * scale
    return x + pe[None]
