"""Host-side filelists and the text-mel dataset.

Counterpart of `efficient_tts_tpu/data/dataset.py`
(`load_filepaths_and_text`, `load_wav`, `TextMelDataset`). Runs on the host in numpy; the card sees only padded,
bucketed batches. The contracts are the JAX package's:
  * filelist lines are `wavpath|text`, shuffled once with seed 1234;
  * wavs are re-based onto `wav_path` by basename, PCM16 scaled by 1/32768;
  * the mel is computed on the fly, [T2, num_mels], by the native library
    (`native/`) when it builds, else by `dsp/mel.py:mel_spectrogram_np`;
  * phone mode maps whitespace-separated phones through the vocab file;
    char mode runs `text_to_sequence` with the cleaners.
The vocoder's segment dataset is not ported yet.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np

from efficient_tts_tpu_torch import native
from efficient_tts_tpu_torch.dsp.mel import MelConfig, mel_spectrogram_np
from efficient_tts_tpu_torch.text import load_phone_vocab, phones_to_sequence, text_to_sequence

log = logging.getLogger(__name__)


def load_filepaths_and_text(filename: str, split: str = "|") -> list:
    with open(filename, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def load_wav(path: str) -> tuple:
    """(raw samples, sample rate) by scipy."""
    from scipy.io.wavfile import read

    sr, data = read(path)
    return data, sr


class TextMelDataset:
    """LJ-style text and mel pairs, the mel extracted on the fly."""

    # __getitem__ is a pure function of the index, so `loader.infinite_loader`
    # may collate a whole-corpus batch once
    deterministic_items = True

    def __init__(
        self,
        meta_file: str,
        text_cleaners=("english_cleaners",),
        max_wav_value: float = 32768.0,
        sampling_rate: int = 22050,
        wav_path: str | None = None,
        use_phnseq: bool = False,
        phnset_path: str | None = None,
        mel_config: MelConfig = MelConfig(),
        mel_cache_dir: str | None = None,
        mel_memory_cache_mb: float = 0.0,
        seed: int = 1234,
    ):
        self.items = load_filepaths_and_text(meta_file)
        self.text_cleaners = list(text_cleaners)
        self.max_wav_value = max_wav_value
        self.sampling_rate = sampling_rate
        self.wav_path = wav_path
        self.use_phnseq = use_phnseq
        self.mel_config = mel_config
        self.mel_cache_dir = mel_cache_dir
        if use_phnseq:
            if phnset_path is None:
                raise ValueError("phnset_path is required when use_phnseq=True")
            self.phn2idx = load_phone_vocab(phnset_path)
        random.Random(seed).shuffle(self.items)
        if mel_cache_dir:
            os.makedirs(mel_cache_dir, exist_ok=True)
        # A bounded in-memory mel cache, first come first kept up to the
        # budget (0 disables it): on a small corpus an epoch is a few
        # batches, and without it every epoch extracts every mel again on
        # the host's critical path. LJSpeech's mels whole would take GBs.
        self._mem_budget = int(mel_memory_cache_mb * (1 << 20))
        self._mem_cache: dict = {}
        self._mem_bytes = 0
        log.info("%s: %d utterances, mels by the %s path", meta_file, len(self.items), native.backend())

    def __len__(self) -> int:
        return len(self.items)

    def get_text(self, text: str) -> np.ndarray:
        if self.use_phnseq:
            ids = phones_to_sequence(text, self.phn2idx)
        else:
            ids = text_to_sequence(text, self.text_cleaners)
        return np.asarray(ids, dtype=np.int32)

    def _resolve_wav(self, audiopath: str) -> str:
        if self.wav_path:
            return os.path.join(self.wav_path, os.path.basename(audiopath))
        return audiopath

    def get_mel(self, audiopath: str) -> np.ndarray:
        """[T2, num_mels] log-mel."""
        path = self._resolve_wav(audiopath)
        mem = self._mem_cache.get(path)
        if mem is not None:
            return mem
        cache = None
        if self.mel_cache_dir:
            base = os.path.splitext(os.path.basename(path))[0]
            cache = os.path.join(self.mel_cache_dir, base + ".mel.npy")
            if os.path.exists(cache):
                return self._mem_put(path, np.load(cache))
        decoded = native.decode_wav(path)
        if decoded is not None:
            audio, sr = decoded
        else:
            raw, sr = load_wav(path)
            audio = raw.astype(np.float32) / self.max_wav_value
        if sr != self.sampling_rate:
            raise ValueError(f"{path}: {sr} Hz != target {self.sampling_rate} Hz")
        mel = native.mel_spectrogram(audio, self.mel_config)
        if mel is None:
            mel = mel_spectrogram_np(audio, self.mel_config)
        mel = mel.T  # [T2, n_mels]
        if cache:
            np.save(cache, mel)
        return self._mem_put(path, mel)

    def _mem_put(self, path: str, mel: np.ndarray) -> np.ndarray:
        if self._mem_bytes + mel.nbytes <= self._mem_budget:
            self._mem_cache[path] = mel
            self._mem_bytes += mel.nbytes
        return mel

    def approx_length(self, index: int) -> float:
        """The wav's size in bytes: a mel-length proxy for length-bucketed
        batching that needs no decode."""
        try:
            return float(os.path.getsize(self._resolve_wav(self.items[index][0])))
        except OSError:
            return 0.0

    def __getitem__(self, index: int) -> tuple:
        audiopath, text = self.items[index][0], self.items[index][1]
        return self.get_text(text), self.get_mel(audiopath)
