"""Batched synthesis: text ids -> waveform (counterpart of `efficient_tts_tpu/pipeline.py`).

Either acoustic model of `models/__init__.py` (EFTS-CNN or EFTS-Transformer)
feeds the HiFi-GAN V1 generator:

  stage 1 (`predict_lengths`): text -> aligned positions e; the host reads
      back round(e) at the last valid token and picks the smallest mel
      bucket >= the longest utterance;
  stage 2 (`synthesize_fixed`): decode mel at the bucket length and run the
      vocoder; the tail beyond each utterance's length is masked.

Every entry point runs on `device` ("cuda" by default) and raises without a
card unless the caller passes device="cpu". With the default
compute_dtype=None the decoder and vocoder run in f32, as the JAX package's
do on any backend, and the vocoder's MRF stages take the f32 Hopper kernel;
compute_dtype=torch.bfloat16 takes the bf16 one. f32 convolutions and
products outside the kernels run without TF32, as the JAX reference
computes them in full f32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, as_dtype
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer
from efficient_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from efficient_tts_tpu_torch.ops.alignment import boundary_truncation_correction
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.masks import bucket_length, sequence_mask
from efficient_tts_tpu_torch.utils.precision import full_f32


AcousticModel = EftsCNN | EftsTransformer


@contextlib.contextmanager
def _full_f32():
    with full_f32(), torch.inference_mode():
        yield


def _inputs(model, voc, text, text_lengths, device):
    dev = resolve_device(device)
    if not isinstance(model, model_class_for(model.cfg)):
        raise TypeError(f"{type(model).__name__} does not serve a {type(model.cfg).__name__}")
    for m in (model, voc):
        if m is not None:
            check_module_device(m, dev)
    text = torch.as_tensor(np.asarray(text), dtype=torch.long, device=dev)
    lengths = torch.as_tensor(np.asarray(text_lengths), dtype=torch.long, device=dev)
    return text, lengths


def _stage1(model, text, text_lengths, duration_correction):
    """(e, text value, text mask); False/None = no correction, True = gated
    at 2% of the length, a float = the gate."""
    e, value, tmask = model.infer_durations(text, text_lengths)
    if duration_correction is not False and duration_correction is not None:
        thresh = 0.02 if duration_correction is True else float(duration_correction)
        e = boundary_truncation_correction(e, text_lengths, model.cfg.sigma_e, rel_threshold=thresh)
    return e, value, tmask


def _mel_lengths(e, text_lengths):
    """round(e) at the last valid token, [B] int32."""
    return torch.round(torch.gather(e, 1, (text_lengths - 1)[:, None])[:, 0]).to(torch.int32)


def _decode_and_vocode(model, voc, e, value, tmask, text_lengths, t2, cdt, mrf_impl, output):
    mel, _ = model.infer_decode(value, e, tmask, t2, compute_dtype=cdt)
    mel_lengths = torch.clamp(_mel_lengths(e, text_lengths), 1, t2)
    mel = mel * sequence_mask(mel_lengths, t2, dtype=mel.dtype)[:, :, None]
    wav = voc(mel, compute_dtype=cdt, mrf_impl=mrf_impl)
    hop = voc.cfg.hop_size
    wav_lengths = mel_lengths * hop
    wav = wav * sequence_mask(wav_lengths, t2 * hop, dtype=wav.dtype)
    if output == "pcm16":
        wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    return wav, wav_lengths, mel


def _check_output(output):
    if output not in ("f32", "pcm16"):
        raise ValueError(f"output={output!r}: expected 'f32' or 'pcm16'")


def predict_lengths(model: AcousticModel, text, text_lengths, duration_correction=False, device="cuda"):
    """Stage 1: round(e) at the last valid token, [B] int32 on the device."""
    text, text_lengths = _inputs(model, None, text, text_lengths, device)
    with _full_f32():
        e, _, _ = _stage1(model, text, text_lengths, duration_correction)
        return _mel_lengths(e, text_lengths)


def synthesize_fixed(
    model: AcousticModel,
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
    static mel length t2, all on the device. The decoder and vocoder run in
    f32 by default and in bf16 with `compute_dtype=torch.bfloat16` (the
    alignment stays f32); the MRF stages take the Hopper kernel of that
    dtype on the card, or their plain PyTorch version with
    `mrf_impl="plain"`; `output="pcm16"` quantizes to int16 on the device. For
    an EFTS-Transformer with attn_impl "flash" or "auto", the decoder's
    attention runs the flash kernel on the card when t2 is a multiple of
    128, and its plain-PyTorch XLA branch otherwise."""
    _check_output(output)
    text, text_lengths = _inputs(model, voc, text, text_lengths, device)
    with _full_f32():
        e, value, tmask = _stage1(model, text, text_lengths, duration_correction)
        return _decode_and_vocode(model, voc, e, value, tmask, text_lengths, t2,
                                  as_dtype(compute_dtype), mrf_impl, output)


def synthesize(
    model: AcousticModel,
    voc: HiFiGANGenerator,
    text,
    text_lengths,
    bucket_multiple: int = 64,
    max_t2: int = 2048,
    compute_dtype=None,
    mrf_impl: str = "kernel",
    duration_correction=False,
    output: str = "f32",
    device="cuda",
):
    """Host-driven batched synthesis with automatic bucket choice.
    Returns (wav [B, t2*hop] numpy, wav_lengths [B] int32 numpy); the
    lengths come from the stage-1 readback, and stage 1 runs once.

    The bucket t2 is the longest length rounded up to `bucket_multiple`.
    It decides which decoder attention calls of an EFTS-Transformer are
    eligible for the flash kernel (t2 a multiple of 128): with the default
    64, some buckets are not; `bucket_multiple=128` keeps every decoder
    call on the kernel."""
    _check_output(output)
    text, text_lengths = _inputs(model, voc, text, text_lengths, device)
    with _full_f32():
        e, value, tmask = _stage1(model, text, text_lengths, duration_correction)
        mel_lengths = _mel_lengths(e, text_lengths).cpu().numpy()
        t2 = min(bucket_length(int(mel_lengths.max()), bucket_multiple), max_t2)
        wav, _, _ = _decode_and_vocode(model, voc, e, value, tmask, text_lengths, t2,
                                       as_dtype(compute_dtype), mrf_impl, output)
    wav_lengths = np.clip(mel_lengths, 1, t2).astype(np.int32) * voc.cfg.hop_size
    return wav.cpu().numpy(), wav_lengths
