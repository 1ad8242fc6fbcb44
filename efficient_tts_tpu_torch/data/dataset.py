"""Host-side filelists, the text-mel dataset and the vocoder's segment dataset.

Counterpart of `efficient_tts_tpu/data/dataset.py`
(`load_filepaths_and_text`, `load_wav`, `TextMelDataset`,
`MelAudioSegmentDataset`). Runs on the host in numpy; the card sees only padded,
bucketed batches. The contracts are the JAX package's:
  * filelist lines are `wavpath|text`, shuffled once with seed 1234;
  * wavs are re-based onto `wav_path` by basename, PCM16 scaled by 1/32768;
  * the mel is computed on the fly, [T2, num_mels], by the native library
    (`native/`) when it builds, else by `dsp/mel.py:mel_spectrogram_np`;
  * phone mode maps whitespace-separated phones through the vocab file;
    char mode runs `text_to_sequence` with the cleaners.
`MelAudioSegmentDataset` crops HiFi-GAN's training segments with JAX's
`random.Random(seed)` draws and takes their mels in numpy
(`mel_spectrogram_np`), so its items equal the JAX dataset's.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np

from efficient_tts_tpu_torch import native
from efficient_tts_tpu_torch.dsp.mel import MelConfig, loss_mel_config, mel_spectrogram_np
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


def compute_mel(path: str, sampling_rate: int = 22050, max_wav_value: float = 32768.0,
                mel_config: MelConfig = MelConfig()) -> np.ndarray:
    """A wav's [T2, num_mels] log-mel as `TextMelDataset` takes it (and caches
    it in `mel_cache_dir`): decoded and transformed by the native library when
    it builds, else by scipy and `mel_spectrogram_np`; a wav at another rate
    than `sampling_rate` raises."""
    decoded = native.decode_wav(path)
    if decoded is not None:
        audio, sr = decoded
    else:
        raw, sr = load_wav(path)
        audio = raw.astype(np.float32) / max_wav_value
    if sr != sampling_rate:
        raise ValueError(f"{path}: {sr} Hz != target {sampling_rate} Hz")
    mel = native.mel_spectrogram(audio, mel_config)
    if mel is None:
        mel = mel_spectrogram_np(audio, mel_config)
    return mel.T


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
        mel = compute_mel(path, self.sampling_rate, self.max_wav_value, self.mel_config)
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


class MelAudioSegmentDataset:
    """HiFi-GAN's vocoder dataset: (mel [F, n_mels], audio [segment_size],
    mel_loss [F, n_mels]) of a fixed-size waveform segment.

    The files are shuffled once with `seed`; the audio is PCM scaled by
    1 / max_wav_value and, unless fine-tuning, peak-normalized to 0.95. With
    `split` a random segment is cropped (a shorter file is zero-padded) by a
    `random.Random(seed)` shared across items, as the JAX dataset draws. The
    generator input is the segment's mel; with `fine_tuning` it is the GTA
    mel `base_mels_path/<utt>.npy` ([n_mels, T2], from `bin/extract_gta.py`)
    cropped at the same frame as the audio. The loss target `mel_loss` comes
    from `loss_mel_config(mel_config, fmax_loss)`, the filterbank the GAN step
    takes the generated audio's mel with.
    """

    def __init__(self, files: list, segment_size: int = 8192, sampling_rate: int = 22050,
                 mel_config: MelConfig = MelConfig(), fmax_loss: float | None = None,
                 max_wav_value: float = 32768.0, seed: int = 1234, split: bool = True, shuffle: bool = True,
                 fine_tuning: bool = False, base_mels_path: str | None = None):
        self.files = list(files)
        if shuffle:
            random.Random(seed).shuffle(self.files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.mel_config = mel_config
        self.loss_config = loss_mel_config(mel_config, fmax_loss)
        self.max_wav_value = max_wav_value
        self.split = split
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        if fine_tuning and not base_mels_path:
            raise ValueError("fine_tuning requires base_mels_path (GTA mels)")
        self._rng = random.Random(seed)
        # with split, an item is a new random crop each time: the loader's
        # whole-corpus-batch cache would freeze every crop at its first place
        self.deterministic_items = not split

    def __len__(self) -> int:
        return len(self.files)

    def _load_audio(self, index: int) -> np.ndarray:
        audio, sr = load_wav(self.files[index])
        if sr != self.sampling_rate:
            raise ValueError(f"{self.files[index]}: {sr} != {self.sampling_rate}")
        audio = audio.astype(np.float32) / self.max_wav_value
        if not self.fine_tuning:
            peak = np.abs(audio).max()
            if peak > 0:
                audio = audio / peak * 0.95
        return audio

    def __getitem__(self, index: int) -> tuple:
        audio = self._load_audio(index)
        hop, seg = self.mel_config.hop_size, self.segment_size
        if self.fine_tuning:
            base = os.path.splitext(os.path.basename(self.files[index]))[0]
            mel = np.load(os.path.join(self.base_mels_path, base + ".npy")).T  # [T2, n_mels]
            if self.split:
                frames = -(-seg // hop)
                if len(audio) >= seg and mel.shape[0] > frames:
                    start = self._rng.randint(0, mel.shape[0] - frames - 1)
                    mel = mel[start: start + frames]
                    audio = audio[start * hop: (start + frames) * hop]
                else:
                    mel = np.pad(mel, ((0, max(0, frames - mel.shape[0])), (0, 0)))[:frames]
                    audio = np.pad(audio, (0, max(0, seg - len(audio))))[:seg]
        else:
            if self.split:
                if len(audio) >= seg:
                    start = self._rng.randint(0, len(audio) - seg)
                    audio = audio[start: start + seg]
                else:
                    audio = np.pad(audio, (0, seg - len(audio)))
            mel = mel_spectrogram_np(audio, self.mel_config).T
        return mel, audio, mel_spectrogram_np(audio, self.loss_config).T
