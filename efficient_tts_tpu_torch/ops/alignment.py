"""IMV alignment ops, all float32.

Counterpart of `efficient_tts_tpu/ops/alignment.py`: `masked_softmax`,
`alignment_from_positions` and `boundary_truncation_correction` (inference
and training), and the training-only chain `scaled_dot_attention`,
`index_vector`, `imv_from_alpha` and `aligned_positions`. Masked entries
are filled with -1e30 (finite), so a fully masked row gives zeros rather
than NaN.

The JAX matvecs run at Precision.HIGHEST, so on the card these ops run
with TF32 off (the train step's `utils/precision.py:full_f32`). Gradients
at ties follow JAX: `torch.maximum` splits the gradient half and half
where its arguments are equal, as `jnp.maximum` does (relu and clamp give
it to one side), and `amax` spreads it evenly over tied maxima, as
`jnp.max` does; a monotone imv that ends in a plateau has such ties.
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


def scaled_dot_attention(query: torch.Tensor, key: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """Single-head soft alignment: query [B, T2, D] (mel), key [B, T1, D]
    (text), key_mask [B, T1] -> alpha [B, T1, T2], softmax over the text axis."""
    scores = torch.einsum("btd,bsd->bts", query.float(), key.float()) / math.sqrt(query.shape[-1])
    return masked_softmax(scores, key_mask[:, None, :], dim=-1).transpose(1, 2)


def index_vector(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] mask -> masked position indices [B, T] f32."""
    return torch.arange(mask.shape[-1], dtype=torch.float32, device=mask.device)[None, :] * mask.float()


def imv_from_alpha(alpha: torch.Tensor, p: torch.Tensor, mel_mask: torch.Tensor,
                   text_lengths: torch.Tensor) -> torch.Tensor:
    """Monotonic index mapping vector [B, T2]: pi = alpha^T p, made monotone
    by max(diff, 0) and a cumsum, rescaled so its maximum is T1 - 1."""
    imv_dummy = torch.einsum("bst,bs->bt", alpha, p)
    diff = imv_dummy[:, 1:] - imv_dummy[:, :-1]
    delta = torch.maximum(diff, torch.zeros((), dtype=diff.dtype, device=diff.device))
    delta = torch.cat([torch.zeros_like(delta[:, :1]), delta], dim=-1)
    imv = torch.cumsum(delta, dim=-1) * mel_mask.float()
    last = torch.maximum(imv.amax(dim=-1), torch.tensor(1e-8, device=imv.device))
    scale = (text_lengths.float() - 1.0) / last
    return imv * scale[:, None]


def aligned_positions(imv: torch.Tensor, p: torch.Tensor, mel_mask: torch.Tensor, text_mask: torch.Tensor,
                      sigma_e: float = 0.5) -> torch.Tensor:
    """Expected mel position per token, e [B, T1]:
    e[b, i] = sum_t softmax_t(-sigma_e (imv[b, t] - p[b, i])^2) q[b, t]."""
    energies = -sigma_e * torch.square(imv[:, None, :] - p[:, :, None])
    beta = masked_softmax(energies, mel_mask[:, None, :], dim=-1)
    e = torch.einsum("bst,bt->bs", beta, index_vector(mel_mask))
    return e * text_mask.float()


def alignment_from_positions(
    e: torch.Tensor, t2: int, sigma: float = 0.01, mel_mask=None, text_mask=None, offset: int = 0
) -> torch.Tensor:
    """alpha'[b, i, t] = softmax_i(-sigma (q[b, t] - e[b, i])^2), [B, T1, T2];
    the frames' positions start at `offset` (a sequence-parallel rank's)."""
    q = torch.arange(offset, offset + t2, dtype=torch.float32, device=e.device)[None, :]
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
