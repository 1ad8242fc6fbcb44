"""Mel filterbank and window construction (host-side, numpy).

Copy of `efficient_tts_tpu/dsp/filters.py`: the Slaney-style mel
filterbank of `librosa.filters.mel` (sr=22050, n_fft=1024, n_mels=80,
fmin=0, fmax=8000, htk=False, norm='slaney'), implemented from the
published formulas so there is no librosa dependency, and the periodic
Hann window of `torch.hann_window`.
"""

from __future__ import annotations

import functools

import numpy as np

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = np.log(6.4) / 27.0  # step size for log region
_F_SP = 200.0 / 3  # Hz per mel in the linear region


def hz_to_mel(freq):
    """Slaney mel scale (librosa htk=False)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = 8000.0,
    dtype=np.float32,
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_lo, mel_hi = hz_to_mel(fmin), hz_to_mel(fmax)
    mel_pts = mel_to_hz(np.linspace(mel_lo, mel_hi, n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, n_bins]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style normalization: equal area per band.
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(dtype)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, matching `torch.hann_window(win_length)`
    (periodic=True) used at `meldataset.py:69`."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)
