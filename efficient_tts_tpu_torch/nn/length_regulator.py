"""Length regulator: repeat text states by per-token durations.

Counterpart of `efficient_tts_tpu/nn/length_regulator.py`, which builds a
one-hot [B, max_len, T1] assignment from the cumulative durations and
multiplies. Here frame t takes the state of the token i with cum[i - 1] <=
t < cum[i], found by `searchsorted` and gathered: the same frames with no
product, so no TF32 rounding on the card. Frames past sum(durations) are
`pad_value`. Nothing in the JAX package calls it; EFTS expands through its
alignment instead.
"""

from __future__ import annotations

import torch


def length_regulator(x: torch.Tensor, durations: torch.Tensor, max_len: int, pad_value: float = 0.0) -> torch.Tensor:
    """x [B, T1, C], durations [B, T1] (ints) -> [B, max_len, C]."""
    cum = torch.cumsum(torch.as_tensor(durations, device=x.device).long(), dim=1)
    t = torch.arange(max_len, device=x.device).expand(x.shape[0], max_len).contiguous()
    token = torch.searchsorted(cum, t, right=True)  # the first token ending after t
    valid = t < cum[:, -1:]
    y = torch.gather(x, 1, token.clamp(max=x.shape[1] - 1)[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[..., None], y, torch.full((), pad_value, dtype=x.dtype, device=x.device))
