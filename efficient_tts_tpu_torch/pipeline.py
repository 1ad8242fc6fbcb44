"""Batched synthesis: text ids -> waveform (counterpart of `efficient_tts_tpu/pipeline.py`).

  stage 1 (`predict_lengths`): text -> aligned positions e; the host reads
      back round(e) at the last valid token and picks the smallest mel
      bucket >= the longest utterance;
  stage 2 (`synthesize_fixed`): decode mel at the bucket length and run the
      vocoder; the tail beyond each utterance's length is masked.

Every entry point runs on `device` ("cuda" by default) and raises without a
card unless the caller passes device="cpu". f32 convolutions run without
TF32, as the JAX reference computes them in full f32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, as_dtype
from efficient_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from efficient_tts_tpu_torch.ops.alignment import boundary_truncation_correction
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.masks import bucket_length, sequence_mask


@contextlib.contextmanager
def _full_f32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _inputs(models, text, text_lengths, device):
    dev = resolve_device(device)
    for m in models:
        check_module_device(m, dev)
    text = torch.as_tensor(np.asarray(text), dtype=torch.long, device=dev)
    lengths = torch.as_tensor(np.asarray(text_lengths), dtype=torch.long, device=dev)
    return text, lengths


def _maybe_correct(e, text_lengths, sigma_e, duration_correction):
    """False/None = off; True = gated at 2% of the length; a float = the gate."""
    if duration_correction is False or duration_correction is None:
        return e
    thresh = 0.02 if duration_correction is True else float(duration_correction)
    return boundary_truncation_correction(e, text_lengths, sigma_e, rel_threshold=thresh)


def _last_position(e, text_lengths):
    return torch.gather(e, 1, (text_lengths - 1)[:, None])[:, 0]


def predict_lengths(efts: EftsCNN, text, text_lengths, duration_correction=False, device="cuda"):
    """Stage 1: round(e) at the last valid token, [B] int32 on the device."""
    text, text_lengths = _inputs([efts], text, text_lengths, device)
    with _full_f32():
        e, _, _ = efts.infer_durations(text, text_lengths)
        e = _maybe_correct(e, text_lengths, efts.cfg.sigma_e, duration_correction)
        return torch.round(_last_position(e, text_lengths)).to(torch.int32)


def synthesize_fixed(
    efts: EftsCNN,
    voc: HiFiGANGenerator,
    text,
    text_lengths,
    t2: int,
    compute_dtype=None,
    mrf_impl: str = "kernel",
    duration_correction=False,
    output: str = "f32",
    device="cuda",
):
    """Text -> (wav [B, t2*hop], wav_lengths [B], mel [B, t2, odim]) at a
    static mel length t2, all on the device. `compute_dtype=torch.bfloat16`
    runs the decoder and vocoder in bf16 (the alignment stays f32);
    `output="pcm16"` quantizes to int16 on the device; `mrf_impl="plain"`
    runs the MRF stages' plain PyTorch version instead of the kernel."""
    if output not in ("f32", "pcm16"):
        raise ValueError(f"output={output!r}: expected 'f32' or 'pcm16'")
    text, text_lengths = _inputs([efts, voc], text, text_lengths, device)
    cdt = as_dtype(compute_dtype)
    hop = voc.cfg.hop_size
    with _full_f32():
        e, value, tmask = efts.infer_durations(text, text_lengths)
        e = _maybe_correct(e, text_lengths, efts.cfg.sigma_e, duration_correction)
        mel, _ = efts.infer_decode(value, e, tmask, t2, compute_dtype=cdt)
        mel_lengths = torch.clamp(torch.round(_last_position(e, text_lengths)).to(torch.int32), 1, t2)
        mel = mel * sequence_mask(mel_lengths, t2, dtype=mel.dtype)[:, :, None]
        wav = voc(mel, compute_dtype=cdt, mrf_impl=mrf_impl)
        wav_lengths = mel_lengths * hop
        wav = wav * sequence_mask(wav_lengths, t2 * hop, dtype=wav.dtype)
        if output == "pcm16":
            wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    return wav, wav_lengths, mel


def synthesize(
    efts: EftsCNN,
    voc: HiFiGANGenerator,
    text,
    text_lengths,
    bucket_multiple: int = 64,
    max_t2: int = 2048,
    compute_dtype=None,
    duration_correction=False,
    output: str = "f32",
    device="cuda",
):
    """Host-driven batched synthesis with automatic bucket choice.
    Returns (wav [B, t2*hop] numpy, wav_lengths [B] int32 numpy); the
    lengths come from the stage-1 readback."""
    mel_lengths = predict_lengths(
        efts, text, text_lengths, duration_correction=duration_correction, device=device
    ).cpu().numpy()
    t2 = min(bucket_length(int(mel_lengths.max()), bucket_multiple), max_t2)
    wav, _, _ = synthesize_fixed(
        efts, voc, text, text_lengths, t2, compute_dtype=compute_dtype,
        duration_correction=duration_correction, output=output, device=device,
    )
    wav_lengths = np.clip(mel_lengths, 1, t2).astype(np.int32) * voc.cfg.hop_size
    return wav.cpu().numpy(), wav_lengths
