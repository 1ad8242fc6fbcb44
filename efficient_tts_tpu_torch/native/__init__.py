"""ctypes bindings of the native host DSP library (`mel_native.cc`).

Counterpart of `efficient_tts_tpu/native/__init__.py`. At first use the
source is built with g++ into `efficient_tts_tpu_torch/_build/` (named by
a hash of the source and the flags, so an edited source is rebuilt); when
g++ or the build is missing, every entry point returns None and the
callers take the numpy path (`dsp/mel.py:mel_spectrogram_np`, scipy's wav
reader). `backend()` names the path that runs, and the first use logs it.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "mel_native.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libeftsnative.{h}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True,
                       timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.info("native host DSP: the g++ build failed (%s)", e)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _target()
        if not out.exists() and not _build(out):
            log.info("native host DSP unavailable: the data pipeline takes the numpy path")
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            log.info("native host DSP: loading %s failed (%s); the numpy path runs", out, e)
            return None
        lib.efts_decode_wav.restype = ctypes.c_int64
        lib.efts_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.efts_mel_spectrogram.restype = ctypes.c_int64
        lib.efts_mel_spectrogram.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        log.info("native host DSP: %s", out)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """"native" when the library built and loaded, else "numpy"."""
    return "native" if available() else "numpy"


def decode_wav(path: str):
    """(float32 samples, PCM16 scaled by 1/32768, sample rate), or None when
    the native path is unavailable or the file is not PCM16 or float32."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    max_out = len(buf) // 2 + 16
    out = np.empty(max_out, np.float32)
    sr = ctypes.c_int32(0)
    n = lib.efts_decode_wav(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_out,
                            ctypes.byref(sr))
    if n < 0:
        return None
    return out[:n].copy(), int(sr.value)


def mel_spectrogram(wav: np.ndarray, cfg=None) -> np.ndarray | None:
    """[T] float32 -> [n_mels, frames] log-mel, or None when unavailable;
    the numerics of `dsp/mel.py:mel_spectrogram_np` (the same window and
    filterbank) up to the FFT's f32 rounding."""
    from efficient_tts_tpu_torch.dsp.filters import mel_filterbank
    from efficient_tts_tpu_torch.dsp.mel import MelConfig, num_frames, padded_window

    lib = _load()
    if lib is None:
        return None
    if cfg is None:
        cfg = MelConfig()
    wav = np.ascontiguousarray(wav, np.float32)
    win = np.ascontiguousarray(padded_window(cfg), np.float32)
    basis = np.ascontiguousarray(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax),
                                 np.float32)
    frames = num_frames(len(wav), cfg)
    out = np.empty((cfg.num_mels, max(frames, 1)), np.float32)
    got = lib.efts_mel_spectrogram(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav),
        win.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), basis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cfg.n_fft, cfg.hop_size, cfg.num_mels, np.float32(cfg.mag_eps), np.float32(cfg.clip_val),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got < 0:
        return None
    return out[:, :got]
