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

Under sequence parallelism (`sp=`, `parallel/sequence_parallel.py:SeqShard`)
a rank holds T / m consecutive frames: its queries attend to the keys and
values of the whole sequence, gathered from the row (`attend` takes them
gathered), and the call is flash-eligible or not by the whole sequence's
length, as JAX's GSPMD decides it on global shapes. The kernels then run at
Tq = T / m against Tk = T; rows that are not a multiple of 64 are padded
for them and dropped after.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
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


def _flash_rows(q, k, v, mask, start: int, fn):
    """The flash path on query rows start.. of the sequence of k and v. The
    key-padding mask becomes segment ids (valid 1, pad 0), the queries
    taking their rows' ids. The kernels take query rows in multiples of 64:
    other counts are padded with zero queries whose segment id (-1) no key
    has, which stay finite (the mask value is finite) and are dropped, so
    their gradient is 0 and adds nothing to the keys' and values'."""
    tq, dk = q.shape[2:]
    pad = -tq % 64
    seg = None
    if mask is not None:
        kv = mask[:, 0, :].to(torch.int32).contiguous()
        ids = kv if (start, tq) == (0, k.shape[2]) else kv[:, start:start + tq]
        if pad:
            ids = F.pad(ids, (0, pad), value=-1)
        seg = SegmentIds(ids.contiguous(), kv)
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
    return fn(q, k, v, seg, sm_scale=1.0 / float(np.sqrt(dk)))[:, :, :tq]


def attend(q, k, v, mask=None, impl: str = "xla", dropout_rate: float = 0.0, gen=None, deterministic: bool = True,
           start: int = 0):
    """The attention core: query rows q [B, H, Tq, dk], rows start.. of a
    self-attention whose keys and values k, v [B, H, T, dk] span the whole
    sequence (Tq = T and start 0 on one rank) -> [B, H, Tq, dk]. mask
    [B, 1|T, T] True = valid, or None. `impl` "flash" or "flash_plain" takes
    the flash path when `flash_eligible` admits the whole sequence's call;
    every other call takes the XLA branch, whose attention-probability
    dropout gives the rows their part of the whole [B, H, T, T] mask."""
    t = k.shape[2]
    if impl in ("flash", "flash_plain") and flash_eligible(t, t, mask, dropout_rate, deterministic):
        return _flash_rows(q, k, v, mask, start, flash_attention if impl == "flash" else flash_attention_reference)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        m = mask[:, None, :, :]
        attn = torch.softmax(scores.masked_fill(~m, -1e30), dim=-1).masked_fill(~m, 0.0)
    else:
        attn = torch.softmax(scores, dim=-1)
    attn = dropout(attn, dropout_rate, gen, deterministic, window=(t, start), axis=2)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_feat: int, n_head: int):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat={n_feat} is not a multiple of n_head={n_head}")
        self.n_head = n_head
        self.q, self.k, self.v, self.out = (Linear(n_feat, n_feat) for _ in range(4))

    def forward(self, x, mask=None, impl: str = "xla", dropout_rate: float = 0.0, gen=None,
                deterministic: bool = True, sp=None):
        """x [B, T, D] -> [B, T, D]; mask [B, 1|T, T] True = valid. With
        `deterministic=False` and a rate, the XLA branch drops attention
        probabilities with generator `gen` and no call is flash-eligible.
        With `sp` x is the rank's frames [B, T / m, D] and mask the whole
        sequence's [B, 1, T]: the keys and values come from the gathered
        frames."""
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}: expected one of {IMPLS}")
        b, t, d = x.shape
        dk = d // self.n_head

        def heads(lin, y):
            return lin(y).view(b, y.shape[1], self.n_head, dk).transpose(1, 2)  # [B, H, T, dk]

        kv = x if sp is None else sp.gather(x)
        q, k, v = heads(self.q, x), heads(self.k, kv), heads(self.v, kv)
        if impl == "auto":
            impl = "flash" if x.device.type == "cuda" else "xla"
        ctx = attend(q, k, v, mask, impl, dropout_rate, gen, deterministic, start=0 if sp is None else sp.index * t)
        return self.out(ctx.transpose(1, 2).reshape(b, t, d))


def positional_encoding(t: int, d: int, dtype=torch.float32, device=None, offset: int = 0) -> torch.Tensor:
    """Sinusoidal table [T, D] (rows offset.. of the table of a longer
    sequence), built in float64 and cast once."""
    position = np.arange(offset, offset + t)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2).astype(np.float64) * -(np.log(10000.0) / d))
    pe = np.zeros((t, d))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def add_positional_encoding(x: torch.Tensor, scale: torch.Tensor | None = None, offset: int = 0) -> torch.Tensor:
    """x [B, T, D] + PE in x's dtype; a learnable `scale` (cast to x's
    dtype by the caller) multiplies the table first. With `offset` x is
    frames offset.. of a longer sequence (a rank's frames under sequence
    parallelism) and takes those rows of its table."""
    pe = positional_encoding(x.shape[1], x.shape[2], x.dtype, x.device, offset)
    if scale is not None:
        pe = pe * scale
    return x + pe[None]
