"""BigVGAN's anti-aliased periodic activation, as plain PyTorch ops.

Counterpart of NVIDIA/BigVGAN's `alias_free_activation/torch/act.py`
(`Activation1d` around `activations.SnakeBeta`, up and down ratio 2,
12-tap filters). On channels-first x [B, C, T]:

  upsample 2x: pad x by 5 samples a side, replicating its edges; take 2 x
      the depthwise conv_transpose1d with the filter h at stride 2 (the 2
      is folded into the taps, which is exact); keep [15, -15): length 2T;
  SnakeBeta: y = x + sin^2(alpha_c x) / (beta_c + 1e-9), one alpha and one
      beta a channel (`snake_coefficients`: exp of the parameters under
      `snake_logscale`); the reciprocal is taken once, as the published
      code computes (1 / (beta + 1e-9)) * sin^2;
  downsample 2x: pad 5 left and 6 right, replicating edges; the depthwise
      conv1d with h at stride 2: length T.

h (`kaiser_sinc_filter`) is the published Kaiser-windowed sinc: cutoff
0.25, half-width 0.3, 12 taps, normalised to sum 1. No kernel of the port
computes this yet; each call is about ten passes over a tensor of 2T
samples. While a torch profiler runs, each call records the span
`bigvgan.act` with its device time (`utils/profiling.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.utils.profiling import span

TAPS = 12
CUTOFF = 0.25  # 0.5 / ratio
HALF_WIDTH = 0.3  # 0.6 / ratio
SNAKE_EPS = 1e-9


def kaiser_sinc_filter() -> torch.Tensor:
    """The 12 f32 taps of h, computed as `alias_free_activation/torch/filter.py:
    kaiser_sinc_filter1d` computes them (its A > 50 branch)."""
    half = TAPS // 2
    attenuation = 2.285 * (half - 1) * math.pi * (4 * HALF_WIDTH) + 7.95
    beta = 0.1102 * (attenuation - 8.7)
    window = torch.kaiser_window(TAPS, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    h = 2 * CUTOFF * window * torch.sinc(2 * CUTOFF * t)
    return h / h.sum()


def snake_coefficients(alpha, beta, logscale: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, 1 / (beta + 1e-9)) per channel from SnakeBeta's parameters."""
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return alpha, 1.0 / (beta + SNAKE_EPS)


def upsample2(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, 2T]."""
    c = x.shape[1]
    w = (2.0 * h).to(x.dtype).view(1, 1, TAPS).expand(c, 1, TAPS)
    y = F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), w, stride=2, groups=c)
    return y[..., 15:-15]


def downsample2(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[B, C, 2T] -> [B, C, T]."""
    c = x.shape[1]
    w = h.to(x.dtype).view(1, 1, TAPS).expand(c, 1, TAPS)
    return F.conv1d(F.pad(x, (5, 6), mode="replicate"), w, stride=2, groups=c)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor) -> torch.Tensor:
    """x + inv_beta_c * sin^2(alpha_c x) on [B, C, T]; alpha, inv_beta [C]."""
    return x + inv_beta.to(x.dtype)[:, None] * torch.sin(x * alpha.to(x.dtype)[:, None]).square()


def anti_aliased_snake_beta(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
                            h: torch.Tensor) -> torch.Tensor:
    """Upsample 2x, SnakeBeta, downsample 2x: [B, C, T] -> [B, C, T]."""
    with span("bigvgan.act", device=True):
        return downsample2(snake_beta(upsample2(x, h), alpha, inv_beta), h)
