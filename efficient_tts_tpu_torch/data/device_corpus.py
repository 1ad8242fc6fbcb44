"""The vocoder corpus held on the card (counterpart of `efficient_tts_tpu/data/device_corpus.py`).

The host data path (`MelAudioSegmentDataset` on a worker thread) crops 16
segments and computes 32 numpy mels a step, then copies the batch to the
card. Here the whole wav corpus is uploaded once, and each step's random
crops and both mels are computed on the card, next to the GAN step that
consumes them: the steady-state loop copies nothing from the host.

  * `load_corpus` reads every wav, peak-normalizes it to 0.95 on the host
    exactly as `MelAudioSegmentDataset._load_audio` does, and pads them
    into one f32 tensor [N, L], zero past each wav's length, where L is
    max(longest wav, segment) rounded up to a multiple of 1024.
  * `corpus_nbytes` gives that tensor's size, N x L x 4 bytes, from the RIFF
    headers alone (16-, 24- and 32-bit integer and 32-bit float wavs), for
    `bin/train_vocoder.py`'s `--device_corpus auto` budget of 2 GiB. Every
    wav pads to the longest: LJSpeech (13,100 wavs, the longest about
    10.1 s) would take 13,100 x 223,232 x 4 B, about 11.7 GB, so `auto`
    keeps it on the host path, as the JAX package does.
  * `make_device_batch_fn` crops and takes the mels. `crop_positions`
    draws wav indices i.i.d. uniform over N and starts
    min(floor(u * (max_start + 1)), max_start), max_start = max(len -
    segment, 0), as JAX does; a wav shorter than a segment gives the wav
    and zeros, as the host path's `np.pad` does. The draws come from a
    `torch.Generator` on the corpus's device seeded by a function of
    (seed, step) alone, so the crop stream is a pure function of the step
    and a resumed run continues it exactly, with no host state to save.
    The card's stream differs from the CPU's, and neither equals JAX's
    threefry stream; `batch_from_positions` takes given positions, so the
    tests feed it JAX's.

Selection is i.i.d. per batch slot, not an epoch permutation: every wav is
equally likely at every step. GTA fine-tuning needs the stored ragged mels,
so it stays on the host path (`bin/train_vocoder.py` refuses
`--device_corpus on` with `--fine_tuning`). The crops and the STFT are plain
PyTorch: the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import logging
import os
import struct

import numpy as np
import torch

from efficient_tts_tpu_torch.data.dataset import load_wav
from efficient_tts_tpu_torch.dsp.mel import MelConfig, log_mel, loss_mel_config, stft_magnitude
from efficient_tts_tpu_torch.utils.device import resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32

log = logging.getLogger(__name__)

WIDTH_MULTIPLE = 1024


def padded_width(longest: int, segment_size: int) -> int:
    """L: max(longest, segment_size) rounded up to a multiple of 1024."""
    return -(-max(longest, segment_size) // WIDTH_MULTIPLE) * WIDTH_MULTIPLE


def load_corpus(files: list, sampling_rate: int = 22050, max_wav_value: float = 32768.0,
                segment_size: int = 8192, device="cuda") -> dict:
    """{"wav": [N, L] f32, "len": [N] int32} on `device`, uploaded once."""
    dev = resolve_device(device)
    wavs = []
    for path in files:
        audio, sr = load_wav(path)
        if sr != sampling_rate:
            raise ValueError(f"{path}: {sr} != {sampling_rate}")
        audio = audio.astype(np.float32) / max_wav_value
        peak = np.abs(audio).max()
        if peak > 0:
            audio = audio / peak * 0.95
        wavs.append(audio)
    host = torch.zeros((len(wavs), padded_width(max(len(w) for w in wavs), segment_size)), dtype=torch.float32)
    for i, w in enumerate(wavs):
        host[i, : len(w)] = torch.from_numpy(w)
    lengths = torch.tensor([len(w) for w in wavs], dtype=torch.int32)
    if dev.type == "cuda":
        host, lengths = host.pin_memory(), lengths.pin_memory()
    corpus = {"wav": host.to(dev), "len": lengths.to(dev)}
    log.info("device-resident corpus: %d wavs, %.1f MB on %s", len(wavs), corpus["wav"].nbytes / 2**20, dev)
    return corpus


def wav_frames(path: str) -> int:
    """A wav's frame count from its RIFF header: the `data` chunk's size over
    the `fmt ` chunk's block alignment, whatever the sample format."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path} is not a RIFF WAVE file")
        block_align = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: no data chunk")
            chunk, n = struct.unpack("<4sI", head)
            if chunk == b"fmt ":
                block_align = struct.unpack("<HHIIH", f.read(14))[4]
                f.seek(n - 14 + (n & 1), os.SEEK_CUR)
            elif chunk == b"data":
                if not block_align:
                    raise ValueError(f"{path}: the data chunk comes before a usable fmt chunk")
                # a streamed writer may leave the size unset: the file's rest bounds it
                return min(n, size - f.tell()) // block_align
            else:
                f.seek(n + (n & 1), os.SEEK_CUR)


def corpus_nbytes(files: list, segment_size: int = 8192) -> int:
    """The bytes of `load_corpus(files, segment_size=...)["wav"]`, exactly,
    without decoding audio: N x L x 4."""
    return len(files) * padded_width(max(wav_frames(f) for f in files), segment_size) * 4


def _step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1))


class DeviceBatcher:
    """`batch_fn(corpus, step) -> {"mel", "audio", "mel_loss"}`: mel and
    mel_loss [B, frames, n_mels], audio [B, segment_size], on `device`,
    where the corpus must lie."""

    def __init__(self, batch_size: int, segment_size: int = 8192, mel_cfg: MelConfig = MelConfig(),
                 fmax_loss: float | None = None, seed: int = 1234, device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.segment_size = segment_size
        self.mel_cfg = mel_cfg
        self.loss_cfg = loss_mel_config(mel_cfg, fmax_loss)
        self.seed = seed

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"the corpus lies on {t.device}, but the batcher runs on {self.device}")

    def crop_positions(self, corpus_len: torch.Tensor, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(wav indices [B] int64, starts [B] int64) of `step`, drawn on
        `corpus_len`'s device from a generator seeded by (seed, step)."""
        self._check(corpus_len)
        dev = corpus_len.device
        gen = torch.Generator(device=dev).manual_seed(_step_seed(self.seed, int(step)))
        idx = torch.randint(0, corpus_len.shape[0], (self.batch_size,), generator=gen, device=dev)
        u = torch.rand((self.batch_size,), generator=gen, device=dev)
        max_start = torch.clamp(corpus_len[idx].long() - self.segment_size, min=0)
        start = torch.minimum(torch.floor(u * (max_start + 1).float()).long(), max_start)
        return idx, start

    def batch_from_positions(self, corpus: dict, idx: torch.Tensor, start: torch.Tensor) -> dict:
        """The B segments wav[idx, start:start + segment_size] and their log-mels."""
        wav = corpus["wav"]
        self._check(wav)
        idx, start = torch.as_tensor(idx, device=wav.device).long(), torch.as_tensor(start, device=wav.device).long()
        offsets = torch.arange(self.segment_size, device=wav.device)
        audio = wav.reshape(-1)[(idx * wav.shape[1] + start)[:, None] + offsets]
        with full_f32():
            # the loss config differs in fmax only: one STFT serves both filterbanks
            mag = stft_magnitude(audio, self.mel_cfg)
            mel = log_mel(mag, self.mel_cfg).transpose(1, 2)
            mel_loss = mel if self.loss_cfg == self.mel_cfg else log_mel(mag, self.loss_cfg).transpose(1, 2)
        return {"mel": mel, "audio": audio, "mel_loss": mel_loss}

    def __call__(self, corpus: dict, step: int) -> dict:
        return self.batch_from_positions(corpus, *self.crop_positions(corpus["len"], step))


def make_device_batch_fn(batch_size: int, segment_size: int = 8192, mel_cfg: MelConfig = MelConfig(),
                         fmax_loss: float | None = None, seed: int = 1234, device="cuda") -> DeviceBatcher:
    return DeviceBatcher(batch_size, segment_size, mel_cfg, fmax_loss, seed, device)


def make_device_gan_train_step(train_step, batch_fn):
    """`device_step(state, corpus) -> (state, metrics)`: the batch of
    `state["step"]` built on the corpus's device, then `train_step` on it."""

    def device_step(state, corpus):
        return train_step(state, batch_fn(corpus, state["step"]))

    device_step.loss_mel_cfg = train_step.loss_mel_cfg
    return device_step
