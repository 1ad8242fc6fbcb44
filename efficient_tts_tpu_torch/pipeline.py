"""Batched synthesis: text ids -> waveform (counterpart of `efficient_tts_tpu/pipeline.py`).

Either acoustic model of `models/__init__.py` (EFTS-CNN or EFTS-Transformer)
feeds a vocoder, the HiFi-GAN generator or BigVGAN's (any module called as
`voc(mel, compute_dtype=, mrf_impl=)` with a `cfg.hop_size`):

  stage 1 (`predict_lengths`): text -> aligned positions e; the host reads
      back round(e) at the last valid token and picks the smallest mel
      bucket >= the longest utterance;
  stage 2 (`synthesize_fixed`): decode mel at the bucket length and run the
      vocoder; the tail beyond each utterance's length is masked.

`synthesize_dispatch` runs stage 1 and its one readback, queues stage 2 and
an asynchronous copy of the waveform to pinned host memory, and returns at
once; `fetch` waits for that copy alone, so a caller can dispatch the next
batch before fetching this one (`synthesize` is the two back to back).
`decode_mel_fixed` is the mel half of stage 2, and `stream_vocoder` vocodes
a host mel window by window for a low time to first audio. While a torch
profiler runs, a dispatch records the spans `pipeline.upload` (the ids'
copy to the device, which waits for the work queued before it),
`pipeline.stage1` (with its device time), `pipeline.readback` (the host
blocked on the mel lengths), `pipeline.stage2` (queueing decode, vocoder,
quantization and the copy), and `fetch` records `pipeline.fetch`
(`utils/profiling.py`).

Over several ranks (`parallel/`, one process per rank, each on its own
`device`): `synthesize_dispatch` / `synthesize` / `fetch` take a `mesh` and
split the batch over its 'data' axis, and `synthesize_fixed_sharded` runs
JAX's dp / tp / sp modes and their "dp+tp" / "dp+sp" combinations. Every
rank calls them alike and gets the whole batch back. Unlike JAX's mesh paths,
which leave the Pallas kernels for XLA's lowering, each rank runs the
single-card path with its kernels; only tp's column slices run cuDNN convs.

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
import dataclasses
import time

import numpy as np
import torch

from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, as_dtype
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer
from efficient_tts_tpu_torch.models.bigvgan import BigVGANGenerator
from efficient_tts_tpu_torch.models.hifigan import HiFiGANGenerator, require_v1_overlap
from efficient_tts_tpu_torch.ops.alignment import boundary_truncation_correction
from efficient_tts_tpu_torch.parallel.mesh import MODEL_AXIS
from efficient_tts_tpu_torch.parallel.sharding import gather_batch, shard_module, split_batch
from efficient_tts_tpu_torch.parallel.tensor_parallel import all_gather
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.masks import bucket_length, sequence_mask
from efficient_tts_tpu_torch.utils.precision import full_f32
from efficient_tts_tpu_torch.utils.profiling import span


AcousticModel = EftsCNN | EftsTransformer
Vocoder = HiFiGANGenerator | BigVGANGenerator


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
    # a copy from pageable host memory waits for the stream's earlier work
    with span("pipeline.upload"):
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


def _decode(model, e, value, tmask, text_lengths, t2, cdt):
    """(mel [B, t2, odim] with the tail past each length zeroed, mel lengths
    clipped to [1, t2])."""
    mel, _ = model.infer_decode(value, e, tmask, t2, compute_dtype=cdt)
    mel_lengths = torch.clamp(_mel_lengths(e, text_lengths), 1, t2)
    return mel * sequence_mask(mel_lengths, t2, dtype=mel.dtype)[:, :, None], mel_lengths


def _decode_and_vocode(model, voc, e, value, tmask, text_lengths, t2, cdt, mrf_impl, output):
    mel, mel_lengths = _decode(model, e, value, tmask, text_lengths, t2, cdt)
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
    voc: Vocoder,
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


def decode_mel_fixed(
    model: AcousticModel,
    text,
    text_lengths,
    t2: int,
    compute_dtype=None,
    duration_correction=False,
    device="cuda",
):
    """Text -> (mel [B, t2, odim], mel_lengths [B] int32) at a static mel
    length t2, on the device: the mel half of `synthesize_fixed`, the tail
    past each utterance's length zeroed, for vocoding apart (streaming,
    inspection)."""
    text, text_lengths = _inputs(model, None, text, text_lengths, device)
    with _full_f32():
        e, value, tmask = _stage1(model, text, text_lengths, duration_correction)
        return _decode(model, e, value, tmask, text_lengths, t2, as_dtype(compute_dtype))


@dataclasses.dataclass
class Dispatched:
    """A dispatched batch's waveform on its way to the host (`fetch` it):
    on the card, a pinned host tensor that a copy on a side stream fills and
    the event that copy records when done; on the CPU the result itself and
    no event. Each dispatch has its own buffer, released when the last
    reference to it (the handle or the fetched array) goes. Under a mesh,
    `gather` instead holds the pending all-gather of every data row's block
    (the work and the list it fills), issued at dispatch so that every rank
    issues its collectives in one order."""

    wav: torch.Tensor | None
    done: torch.cuda.Event | None
    gather: tuple | None = None


def _copy_to_host(wav: torch.Tensor) -> Dispatched:
    """Queue wav's device-to-host copy on a side stream that waits for the
    compute stream's work so far, into a new pinned buffer."""
    if wav.device.type == "cpu":
        return Dispatched(wav, None)
    compute = torch.cuda.current_stream(wav.device)
    side = torch.cuda.Stream(device=wav.device)
    ready = torch.cuda.Event()
    ready.record(compute)
    host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
    done = torch.cuda.Event()
    with torch.cuda.stream(side):
        side.wait_event(ready)
        host.copy_(wav, non_blocking=True)
        done.record(side)
    # the compute stream's allocator must not reuse wav's memory before the copy has read it
    wav.record_stream(side)
    return Dispatched(host, done)


def fetch(handle: Dispatched) -> np.ndarray:
    """The waveform of `synthesize_dispatch`, once its copy is done (it waits
    for that copy's event alone, not for work queued since). Under a mesh it
    completes the gather of the data rows' blocks, as JAX's `_to_host` does
    with `process_allgather`: every rank gets the whole batch."""
    with span("pipeline.fetch"):
        if handle.gather is not None:
            work, parts = handle.gather
            work.wait()
            return torch.cat(parts).cpu().numpy()
        if handle.done is not None:
            handle.done.synchronize()
        return handle.wav.numpy()


def synthesize_dispatch(
    model: AcousticModel,
    voc: Vocoder,
    text,
    text_lengths,
    bucket_multiple: int = 64,
    max_t2: int = 2048,
    compute_dtype=None,
    mrf_impl: str = "kernel",
    duration_correction=False,
    output: str = "f32",
    timings: dict | None = None,
    device="cuda",
    mesh=None,
):
    """Dispatch batched synthesis without waiting for the waveform: stage 1
    and its one readback (the mel lengths, which pick the bucket t2), then
    stage 2 and an asynchronous copy of the waveform to the host are queued.
    Returns (handle, wav_lengths [B] int32 numpy); `fetch(handle)` gives the
    waveform [B, t2*hop]. The lengths are clip(mel_lengths, 1, t2) * hop,
    computed on the host from the readback, as stage 2 computes them. If
    `timings` is a dict it receives the wall-clock splits "stage1_s" (to the
    readback) and "dispatch_s" (queueing stage 2 and the copy), and "t2".

    With a `mesh` every rank passes the whole batch (B divisible by the
    data extent) and synthesizes its data index's block of rows. The mel
    lengths are gathered over the data group before the bucket is picked, so
    every rank picks the one bucket a single card would; the lengths
    returned are the whole batch's, and `fetch` gathers the waveform."""
    _check_output(output)
    t_a = time.perf_counter()
    text, text_lengths = _inputs(model, voc, text, text_lengths, device)
    if mesh is not None:
        text, text_lengths = split_batch(text, mesh), split_batch(text_lengths, mesh)
    with _full_f32():
        with span("pipeline.stage1", device=True):
            e, value, tmask = _stage1(model, text, text_lengths, duration_correction)
            mel_lengths = _mel_lengths(e, text_lengths)
        if mesh is not None:
            mel_lengths = gather_batch(mel_lengths, mesh)
        with span("pipeline.readback"):
            mel_lengths = mel_lengths.cpu().numpy()
        t_b = time.perf_counter()
        t2 = min(bucket_length(int(mel_lengths.max()), bucket_multiple), max_t2)
        with span("pipeline.stage2"):
            wav, _, _ = _decode_and_vocode(model, voc, e, value, tmask, text_lengths, t2,
                                           as_dtype(compute_dtype), mrf_impl, output)
            if mesh is None:
                handle = _copy_to_host(wav)
            else:
                handle = Dispatched(None, None, all_gather(wav, mesh.data_group, async_op=True))
    wav_lengths = np.clip(mel_lengths, 1, t2).astype(np.int32) * voc.cfg.hop_size
    if timings is not None:
        timings.update(stage1_s=t_b - t_a, dispatch_s=time.perf_counter() - t_b, t2=t2)
    return handle, wav_lengths


def synthesize(
    model: AcousticModel,
    voc: Vocoder,
    text,
    text_lengths,
    bucket_multiple: int = 64,
    max_t2: int = 2048,
    compute_dtype=None,
    mrf_impl: str = "kernel",
    duration_correction=False,
    output: str = "f32",
    device="cuda",
    mesh=None,
):
    """Host-driven batched synthesis with automatic bucket choice:
    `synthesize_dispatch`, then `fetch`. Returns (wav [B, t2*hop] numpy,
    wav_lengths [B] int32 numpy); the lengths come from the stage-1
    readback, and stage 1 runs once. With a `mesh` the batch is split over
    its 'data' axis (the data extent must divide B) and every rank gets the
    whole result.

    The bucket t2 is the longest length rounded up to `bucket_multiple`.
    It decides which decoder attention calls of an EFTS-Transformer are
    eligible for the flash kernel (t2 a multiple of 128): with the default
    64, some buckets are not; `bucket_multiple=128` keeps every decoder
    call on the kernel."""
    handle, wav_lengths = synthesize_dispatch(
        model, voc, text, text_lengths, bucket_multiple=bucket_multiple, max_t2=max_t2,
        compute_dtype=compute_dtype, mrf_impl=mrf_impl, duration_correction=duration_correction,
        output=output, device=device, mesh=mesh)
    return fetch(handle), wav_lengths


def _vocode_window(voc: Vocoder, seg: np.ndarray, dev, compute_dtype, mrf_impl) -> torch.Tensor:
    """One host mel window [T, odim] through the generator: [T * hop]."""
    x = torch.from_numpy(np.ascontiguousarray(seg, np.float32)[None]).to(dev)
    with _full_f32():
        return voc(x, compute_dtype=as_dtype(compute_dtype), mrf_impl=mrf_impl)[0]


def stream_vocoder(
    voc: Vocoder,
    mel,
    chunk_frames: int = 64,
    overlap_frames: int = 24,
    compute_dtype=None,
    mrf_impl: str = "kernel",
    device="cuda",
):
    """Waveform chunks (numpy, chunk_frames * hop samples each, the last
    shorter) of a host mel [T, odim], in the overlap-interior scheme of
    `models/hifigan.py:generator_chunked`: with overlap_frames >= 24 each
    chunk is the full pass's interior. It runs at most three window shapes
    for any length, and the first chunk comes after one small window. An
    utterance of at most chunk + 2 * overlap frames is one window, zero-
    padded to chunk_frames rounded up (at most chunk + 2 * overlap). Returns
    a generator; the device and the generator are checked at the call (a
    BigVGAN generator raises: `models/hifigan.py:require_v1_overlap`)."""
    require_v1_overlap(voc, "stream_vocoder")
    dev = resolve_device(device)
    check_module_device(voc, dev)
    return _stream(voc, np.asarray(mel), dev, chunk_frames, overlap_frames, compute_dtype, mrf_impl)


def _stream(voc, mel, dev, chunk_frames, overlap_frames, compute_dtype, mrf_impl):
    t = mel.shape[0]
    hop = voc.cfg.total_upsampling
    ov = overlap_frames
    if t <= chunk_frames + 2 * ov:
        pad_t = min(bucket_length(t, chunk_frames), chunk_frames + 2 * ov)
        seg = np.zeros((pad_t, mel.shape[1]), np.float32)
        seg[:t] = mel
        yield _vocode_window(voc, seg, dev, compute_dtype, mrf_impl)[: t * hop].cpu().numpy()
        return
    n_chunks = -(-t // chunk_frames)
    for i in range(n_chunks):
        lo, hi = i * chunk_frames, min(t, (i + 1) * chunk_frames)
        if i == 0:
            seg, keep_lo = mel[: chunk_frames + ov], 0
        elif i == n_chunks - 1:
            seg, keep_lo = mel[t - (chunk_frames + ov):], chunk_frames + ov - (hi - lo)
        else:
            seg, keep_lo = mel[lo - ov: hi + ov], ov
        wav = _vocode_window(voc, seg, dev, compute_dtype, mrf_impl)
        yield wav[keep_lo * hop: (keep_lo + hi - lo) * hop].cpu().numpy()


# ---------------------------------------------------------------------------
# multi-rank synthesis: dp / tp / sp over a ('data', 'model') mesh of ranks


def _mode_tokens(mode: str) -> set:
    tokens = set(mode.split("+"))
    if tokens - {"dp", "tp", "sp"} or not mode:
        raise ValueError(f"mode {mode!r}: expected '+'-joined tokens from dp/tp/sp")
    return tokens


def _vocode_frames(voc: Vocoder, mel: torch.Tensor, mesh, cdt, overlap_frames: int = 24) -> torch.Tensor:
    """sp: [B, t2, odim] -> [B, t2 * hop] on every rank of the model group.
    Rank j of m vocodes frames [j t2 / m, (j + 1) t2 / m) in a window that
    reaches `overlap_frames` further on each side where the mel goes on, and
    keeps that window's interior; the generator's receptive field is about
    14 frames a side, so 24 make each interior the full pass's, as in
    `models/hifigan.py:generator_chunked`, whose windows these are where m
    divides t2 (the first starts at the true left edge, the last ends at the
    true right edge, so their zero padding is the full pass's). The
    interiors, padded to the longest, are gathered along time. A BigVGAN
    generator raises (`models/hifigan.py:require_v1_overlap`)."""
    require_v1_overlap(voc, "the sequence-parallel vocoder")
    t, hop, ov = mel.shape[1], voc.cfg.total_upsampling, overlap_frames
    m = mesh.shape[MODEL_AXIS]
    bounds = [(i * t // m, (i + 1) * t // m) for i in range(m)]
    lo, hi = bounds[mesh.model_index]
    w_lo, w_hi = max(0, lo - ov), min(t, hi + ov)
    wav = voc(mel[:, w_lo:w_hi].contiguous(), compute_dtype=cdt)
    longest = max(b - a for a, b in bounds) * hop
    piece = torch.zeros((wav.shape[0], longest), dtype=wav.dtype, device=wav.device)
    piece[:, : (hi - lo) * hop] = wav[:, (lo - w_lo) * hop: (hi - w_lo) * hop]
    parts = all_gather(piece, mesh.model_group)
    return torch.cat([p[:, : (b - a) * hop] for p, (a, b) in zip(parts, bounds)], dim=1)


def synthesize_fixed_sharded(
    model: AcousticModel,
    voc: Vocoder,
    text,
    text_lengths,
    t2: int,
    mesh,
    mode: str = "dp",
    compute_dtype=None,
    device="cuda",
):
    """Multi-rank synthesis at a static mel length t2 (counterpart of
    `efficient_tts_tpu/pipeline.py:synthesize_fixed_sharded`). Every rank of
    the mesh calls it with the whole batch and the whole models, each on the
    rank's `device`, and gets (wav [B, t2*hop], wav_lengths [B], mel [B, t2,
    odim]) whole. `mode` is a '+'-joined set of:

      "dp"  the batch over the 'data' axis: each data row synthesizes its
            block of rows, gathered at the end;
      "tp"  parameter channels over 'model' (`parallel/sharding.py`'s rule):
            each rank holds its slice of every sharded leaf and gathers the
            channels after each sharded layer (`parallel/tensor_parallel.py`);
      "sp"  the mel frames over 'model': the acoustic model runs whole on
            every rank and the generator on the rank's share of the frames
            (`_vocode_frames`), gathered along time;
      "dp+tp", "dp+sp"  their combinations on a (data, model) mesh.

    dp and sp run the single-card path, the MRF kernels included, on every
    rank; tp's column slices run cuDNN convs, where JAX's tp lowering reaches
    no Pallas kernel either. No duration correction, as in JAX."""
    tokens = _mode_tokens(mode)
    text, text_lengths = _inputs(model, voc, text, text_lengths, device)
    if "dp" in tokens:
        text, text_lengths = split_batch(text, mesh), split_batch(text_lengths, mesh)
    if "tp" in tokens:
        model, voc = shard_module(model, mesh), shard_module(voc, mesh)
    cdt = as_dtype(compute_dtype)
    with _full_f32():
        e, value, tmask = _stage1(model, text, text_lengths, False)
        mel, mel_lengths = _decode(model, e, value, tmask, text_lengths, t2, cdt)
        wav = _vocode_frames(voc, mel, mesh, cdt) if "sp" in tokens else voc(mel, compute_dtype=cdt)
        hop = voc.cfg.hop_size
        wav_lengths = mel_lengths * hop
        wav = wav * sequence_mask(wav_lengths, t2 * hop, dtype=wav.dtype)
        if "dp" in tokens:
            wav, wav_lengths, mel = (gather_batch(x, mesh) for x in (wav, wav_lengths, mel))
    return wav, wav_lengths, mel
