"""HiFi-GAN's log-mel spectrogram: on the host in numpy, and on tensors.

Counterpart of `efficient_tts_tpu/dsp/mel.py` (`MelConfig`,
`loss_mel_config`, `num_frames`, `mel_spectrogram_np`, and the jitted
`stft_magnitude` / `mel_spectrogram`). The data pipeline computes its mels
on the host, here or in the native library (`native/`); the vocoder's GAN
step takes the mel of the generated audio on the card with
`mel_spectrogram`, in f32 with autograd:

  1. reflect-pad the waveform by (n_fft - hop) / 2 on both sides;
  2. frames of n_fft every hop (center=False), periodic Hann window, rFFT;
  3. magnitude sqrt(re^2 + im^2 + 1e-9);
  4. the Slaney mel filterbank (sr 22050, 1024 fft, 80 mels, fmin 0,
     fmax 8000);
  5. log(clamp(x, min=1e-5)).
The window and the filterbank are made on a device once per config
(`device_constant`): a copy from pageable host memory waits for the
stream's queued work, so making them at every call stopped the host from
running ahead of the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.dsp.filters import hann_window, mel_filterbank


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    num_mels: int = 80
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float | None = 8000.0
    clip_val: float = 1e-5  # the log-compression clamp
    mag_eps: float = 1e-9  # the magnitude's epsilon

    @property
    def pad(self) -> int:
        """The reflect pad on each side, (n_fft - hop) / 2."""
        return (self.n_fft - self.hop_size) // 2


def loss_mel_config(mel_cfg: MelConfig = MelConfig(), fmax_loss: float | None = None) -> MelConfig:
    """The mel config of the vocoder's training loss: the same but with
    fmax = `fmax_loss` (None: full band up to Nyquist, as HiFi-GAN's
    `fmax_for_loss: null`), for the dataset's target and the generated
    audio alike."""
    if fmax_loss == mel_cfg.fmax:
        return mel_cfg
    return MelConfig(**{**mel_cfg.__dict__, "fmax": fmax_loss})


def num_frames(n_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Frames of an unpadded waveform of `n_samples`: 1 + (padded - n_fft)
    // hop after the reflect pad, 0 when shorter than one window."""
    padded = n_samples + 2 * cfg.pad
    if padded < cfg.n_fft:
        return 0
    return 1 + (padded - cfg.n_fft) // cfg.hop_size


def padded_window(cfg: MelConfig) -> np.ndarray:
    """The Hann window of win_size, zero-padded to n_fft around its centre."""
    win = hann_window(cfg.win_size)
    if cfg.win_size < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win_size) // 2
        win = np.pad(win, (lpad, cfg.n_fft - cfg.win_size - lpad))
    return win


def mel_spectrogram_np(y: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """[T] or [B, T] waveform in [-1, 1] -> [num_mels, F] or [B, num_mels, F]
    log-mel (the rFFT in f64, the filterbank product in f32)."""
    squeeze = y.ndim == 1
    y = np.atleast_2d(np.asarray(y, dtype=np.float32))
    pad = cfg.pad
    y = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
    n = y.shape[-1]
    f = 1 + (n - cfg.n_fft) // cfg.hop_size
    starts = np.arange(f) * cfg.hop_size
    idx = starts[:, None] + np.arange(cfg.n_fft)[None, :]
    frames = y[:, idx] * padded_window(cfg)[None, None, :]  # [B, F, n_fft]
    spec = np.fft.rfft(frames.astype(np.float64), n=cfg.n_fft, axis=-1)
    mag = np.sqrt(spec.real**2 + spec.imag**2 + cfg.mag_eps)
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
    mel = basis @ np.swapaxes(mag, -1, -2).astype(np.float32)
    out = np.log(np.clip(mel, cfg.clip_val, None)).astype(np.float32)
    return out[0] if squeeze else out


@functools.lru_cache(maxsize=None)
def device_constant(make, args: tuple, device: torch.device) -> torch.Tensor:
    """`make(*args)` (a numpy array) as an f32 tensor on `device`, made once;
    callers must not write to it."""
    return torch.from_numpy(np.asarray(make(*args), np.float32)).to(device)


def _filterbank(cfg: MelConfig) -> np.ndarray:
    return mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)


def _frames(y: torch.Tensor, pad: int, frame_length: int, hop: int) -> torch.Tensor:
    """[B, T] -> reflect-padded by `pad` each side -> [B, F, frame_length]."""
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(-1, frame_length, hop)


def stft_magnitude(y: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, T] f32 waveform -> [B, n_bins, F] magnitude: reflect pad of
    (n_fft - hop) / 2, frames with center=False, the padded Hann window, an
    f32 rFFT, sqrt(re^2 + im^2 + mag_eps)."""
    win = device_constant(padded_window, (cfg,), y.device)
    spec = torch.fft.rfft(_frames(y, cfg.pad, cfg.n_fft, cfg.hop_size) * win, n=cfg.n_fft, dim=-1)
    return torch.sqrt(spec.real**2 + spec.imag**2 + cfg.mag_eps).transpose(-1, -2)


def log_mel(mag: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, n_bins, F] magnitude -> [B, num_mels, F] log-mel on cfg's filterbank."""
    return torch.log(torch.clamp(device_constant(_filterbank, (cfg,), mag.device) @ mag, min=cfg.clip_val))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, T] f32 waveform -> [B, num_mels, F] log-mel: the filterbank product
    in f32 (call it under `utils/precision.py:full_f32` on the card, as the
    JAX package computes it at Precision.HIGHEST), then log(clamp(., clip_val))."""
    return log_mel(stft_magnitude(y, cfg), cfg)
