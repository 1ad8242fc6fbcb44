"""Multi-resolution STFT loss (counterpart of `efficient_tts_tpu/losses/stft_loss.py`).

Per resolution the spectral convergence ||Y - X||_F / max(||Y||_F, 1e-12)
and the log-magnitude L1, averaged over `DEFAULT_RESOLUTIONS` (fft sizes
1024, 2048, 512, hops 120, 240, 50, Hann windows 600, 1200, 240 padded to
the fft size). The STFT is centered as torch.stft's default: reflect pad
fft_size // 2 each side; the magnitude is sqrt(max(re^2 + im^2, 1e-7)).
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.dsp.filters import hann_window
from efficient_tts_tpu_torch.dsp.mel import _frames, device_constant

DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _window(fft_size: int, win_length: int) -> np.ndarray:
    lpad = (fft_size - win_length) // 2
    return np.pad(hann_window(win_length), (lpad, fft_size - win_length - lpad)).astype(np.float32)


def _stft_magnitude(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> torch.Tensor:
    """[B, T] -> [B, frames, fft_size // 2 + 1]."""
    frames = _frames(x, fft_size // 2, fft_size, hop) * device_constant(_window, (fft_size, win_length), x.device)
    spec = torch.fft.rfft(frames, n=fft_size, dim=-1)
    return torch.sqrt(torch.clamp(spec.real**2 + spec.imag**2, min=1e-7))


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int = 1024, hop: int = 120, win_length: int = 600):
    """(spectral convergence, log-magnitude L1) of x against the target y."""
    x_mag = _stft_magnitude(x, fft_size, hop, win_length)
    y_mag = _stft_magnitude(y, fft_size, hop, win_length)
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.clamp(torch.linalg.vector_norm(y_mag), min=1e-12)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor, resolutions=DEFAULT_RESOLUTIONS):
    """(sc, mag), each averaged across the resolutions."""
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(x, y, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
