"""IMV alignment ops of the inference path, all float32.

Counterpart of `efficient_tts_tpu/ops/alignment.py`: `masked_softmax`,
`alignment_from_positions` and `boundary_truncation_correction`. Masked
entries are filled with -1e30 (finite), so a fully masked row gives zeros
rather than NaN.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax with `mask` (True = valid). Fully-masked rows -> zeros."""
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=dim, keepdim=True)
    ex = torch.exp(scores - m) * mask
    denom = ex.sum(dim=dim, keepdim=True)
    return ex / torch.clamp(denom, min=1e-30)


def alignment_from_positions(
    e: torch.Tensor, t2: int, sigma: float = 0.01, mel_mask=None, text_mask=None
) -> torch.Tensor:
    """alpha'[b, i, t] = softmax_i(-sigma (q[b, t] - e[b, i])^2), [B, T1, T2]."""
    q = torch.arange(t2, dtype=torch.float32, device=e.device)[None, :]
    if mel_mask is not None:
        q = q * mel_mask.float()
    else:
        q = q.expand(e.shape[0], t2)
    energies = -sigma * torch.square(q[:, None, :] - e[:, :, None])
    if text_mask is not None:
        return masked_softmax(energies, text_mask[:, :, None], dim=1)
    alpha = torch.exp(energies - energies.amax(dim=1, keepdim=True))
    return alpha / torch.clamp(alpha.sum(dim=1, keepdim=True), min=1e-30)


def boundary_truncation_correction(
    e: torch.Tensor, text_lengths: torch.Tensor, sigma_e: float = 0.5,
    rel_threshold: float = 0.0,
) -> torch.Tensor:
    """Shift the last valid aligned position (and its padding plateau) by the
    analytic one-sided-truncation bias sqrt(2/pi) * tau, tau = e_last /
    ((T1-1) sqrt(2 sigma_e)); applied per utterance only where the shift
    exceeds `rel_threshold` * e_last (0 = always)."""
    idx_last = (text_lengths - 1)[:, None].long()
    e_last = torch.gather(e, 1, idx_last)
    t1m1 = torch.clamp(text_lengths.to(e.dtype) - 1.0, min=1.0)[:, None]
    tau = e_last / (t1m1 * math.sqrt(2.0 * sigma_e))
    shift = tau * math.sqrt(2.0 / math.pi)
    if rel_threshold:
        shift = torch.where(shift > rel_threshold * e_last, shift, torch.zeros_like(shift))
    pos = torch.arange(e.shape[1], device=e.device)[None, :]
    return e + torch.where(pos >= idx_last, shift, torch.zeros_like(shift))
