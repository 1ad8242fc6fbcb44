"""Serving: the micro-batching TTS engine and a stdlib HTTP server.

Counterpart of `efficient_tts_tpu/serve.py`. `TTSEngine`:

  * encodes text (char or phone front end, `efficient_tts_tpu_torch.text`),
  * pads each micro-batch to a text-length bucket (multiples of
    ``t1_multiple``) and its batch dimension to the next power of two up to
    ``max_batch``, filling it with dummy rows of length 1,
  * dispatches it through `pipeline.synthesize_dispatch` (stage 1, its one
    readback, which picks the mel bucket, then stage 2 and the waveform's
    copy to pinned host memory, queued) and fetches it with
    `pipeline.fetch`; with ``pipeline_fetch`` batch k + 1 is dispatched
    before batch k is fetched,
  * trims every waveform to its true length, copying it out of the batch's
    pinned buffer.

`DynamicBatcher` coalesces single requests arriving within ``max_wait_ms``
of each other into micro-batches, with a gather thread that dispatches and
a fetch thread that fetches, a bounded queue and a queue-wait deadline;
`make_http_server` exposes both over `http.server` (JSON in, RIFF/WAV out).

The engine takes the port's modules: an acoustic model of
`models/__init__.py` and a `HiFiGANGenerator`, both on ``device`` ("cuda"
by default; without a card it raises unless the caller passes
device="cpu"). The MRF stages run the Hopper kernel of the served dtype
(``mrf_impl="kernel"``), or their plain PyTorch version with
``mrf_impl="plain"``, which exists for comparison runs; the engine never
switches between them on its own. There is no compilation per shape here:
``warmup`` walks the JAX engine's bucket grid so that the kernels' first
build, each MRF stage's kernel weights and the pinned-memory pool are made
before the first request.

Over several ranks (``mesh``, `parallel/mesh.py`) every rank builds the
engine alike and calls it with the same requests (SPMD): each micro-batch,
its batch bucket rounded up to a multiple of the data extent, is split over
the mesh's 'data' axis (`pipeline.synthesize_dispatch(mesh=)`) and every rank
gets every waveform. The JAX engine serves "xla" under a mesh, since GSPMD
cannot partition a Pallas call; here each rank runs its own kernels on its
own rows, so ``mrf_impl`` stays what the caller chose. For a server, the
root rank `lead`s: it broadcasts each micro-batch it dispatches to the other
ranks, which `follow` and dispatch it too, until `release_followers`.

Device work comes from several threads at once (the gather and fetch
threads, and HTTP handlers streaming outside the engine lock). The engine
lock serializes dispatches; the counters are kept under locks.

While a torch profiler runs, `utils/profiling.py` records the layer's
spans: `serve.gather` (blocked for the first request, then the wait
window), a `serve.queue` mark per request (from `submit` to the entry of
its micro-batch's dispatch), `engine.dispatch` (the lock wait and the
pipeline's dispatch), `engine.fetch` (the copy's wait and trimming the
rows) and, around it, `serve.deliver` (the fetch and resolving the
requests' futures), the last four under the micro-batch's id.
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import queue
import threading
import time
import wave
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from efficient_tts_tpu_torch import pipeline
from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import as_dtype
from efficient_tts_tpu_torch.parallel.sharding import split_batch
from efficient_tts_tpu_torch.text import phones_to_sequence, text_to_sequence
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.masks import bucket_length
from efficient_tts_tpu_torch.utils.profiling import mark, span

log = logging.getLogger(__name__)


class AdmissionError(RuntimeError):
    """Request rejected at admission (bounded queue full). HTTP: 503."""


class DeadlineExceededError(AdmissionError):
    """Request shed because it aged past its queue-wait deadline before
    dispatch. HTTP: 503. Past saturation every admitted request either meets
    the latency bound or is shed: an unbounded queue turns overload into
    unbounded latency for everyone."""


def encode_wav_bytes(wav: np.ndarray, sampling_rate: int) -> bytes:
    """float32 waveform in (-1, 1), or int16 PCM, -> RIFF/WAV bytes (mono
    PCM_16, float rounded as libsndfile rounds); int16 passes through."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        pcm = wav.astype("<i2")
    else:
        pcm = np.clip(wav.astype(np.float32), -1.0, 1.0)
        pcm = np.round(pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    audio_seconds: float = 0.0
    compute_seconds: float = 0.0
    batch_sizes: list = field(default_factory=list)
    # per-phase wall time summed over batches; the dispatch-side phases and
    # the fetch overlap under pipelining, so the sums can exceed the wall clock
    lock_wait_seconds: float = 0.0
    stage1_seconds: float = 0.0  # duration predict + bucket readback
    dispatch_seconds: float = 0.0  # queueing stage 2 and the host copy
    fetch_seconds: float = 0.0  # wait for the device->host waveform copy
    device_seconds: float = 0.0  # only with detailed_timing (blocking)

    def as_dict(self) -> dict:
        mean_b = float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0
        rtf = self.compute_seconds / max(self.audio_seconds, 1e-9)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "audio_seconds": round(self.audio_seconds, 3),
            "compute_seconds": round(self.compute_seconds, 3),
            "mean_batch_size": round(mean_b, 2),
            "rtf": round(rtf, 6),
            "audio_s_per_s": round(1.0 / max(rtf, 1e-9), 1),
            "lock_wait_seconds": round(self.lock_wait_seconds, 3),
            "stage1_seconds": round(self.stage1_seconds, 3),
            "dispatch_seconds": round(self.dispatch_seconds, 3),
            "fetch_seconds": round(self.fetch_seconds, 3),
            "device_seconds": round(self.device_seconds, 3),
        }


@dataclass
class _BatchHandle:
    """A dispatched but not yet fetched serving micro-batch."""

    wav: pipeline.Dispatched | None  # [bb, t2 * hop] f32 or int16, on its way to pinned memory
    wav_lengths: np.ndarray  # [bb] true sample counts (host)
    n: int  # real (non-padding) utterances
    t0: float  # dispatch-entry wall time
    timings: dict  # phase attribution (lock_wait / stage1 / dispatch / t2)
    batch: int  # the engine's id of this micro-batch, on its spans


class TTSEngine:
    """Bucketed batch synthesis around an acoustic model and a vocoder.

    Thread-safe: a lock serializes the dispatches (stage 1, its readback and
    queueing stage 2); encoding, the fetch and trimming run outside it.
    """

    def __init__(
        self,
        model,
        vocoder,
        *,
        device="cuda",
        max_batch: int = 16,
        t1_multiple: int = 16,
        max_t1: int = 512,
        t2_multiple: int = 64,
        max_t2: int = 2048,
        compute_dtype=None,
        mrf_impl: str = "kernel",
        phone_vocab: dict | None = None,
        cleaner_names=("english_cleaners",),
        pcm16_transfer: bool = True,
        pipeline_fetch: bool = True,
        batch_bucketing: bool = True,
        detailed_timing: bool = False,
        mesh=None,
    ):
        self.device = resolve_device(device)
        if not isinstance(model, model_class_for(model.cfg)):
            raise TypeError(f"{type(model).__name__} does not serve a {type(model.cfg).__name__}")
        for m in (model, vocoder):
            check_module_device(m, self.device)
        if mrf_impl not in ("kernel", "plain"):
            raise ValueError(f"mrf_impl must be 'kernel' or 'plain', got {mrf_impl!r}")
        self.model = model
        self.vocoder = vocoder
        self.efts_cfg = model.cfg
        self.voc_cfg = vocoder.cfg
        self.max_batch = int(max_batch)
        self.t1_multiple = int(t1_multiple)
        self.max_t1 = int(max_t1)
        self.t2_multiple = int(t2_multiple)
        self.max_t2 = int(max_t2)
        self.compute_dtype = as_dtype(compute_dtype)
        self.mrf_impl = mrf_impl
        self.phone_vocab = phone_vocab
        self.cleaner_names = tuple(cleaner_names)
        # pcm16_transfer: quantize waveforms to int16 on the device and copy
        # a quarter of the bytes to the host; the engine still returns f32,
        # exactly pcm / 32767, so re-encoding to WAV gives the device's PCM.
        # pipeline_fetch: overlap batch k's copy to the host with batch k+1's
        # dispatch (synthesize_ids, and DynamicBatcher's fetch thread).
        # detailed_timing: synchronize after queueing stage 2 to split device
        # time from the copy's wait (attribution only: it defeats pipelining).
        self.pcm16_transfer = bool(pcm16_transfer)
        self.pipeline_fetch = bool(pipeline_fetch)
        self.batch_bucketing = bool(batch_bucketing)
        self.detailed_timing = bool(detailed_timing)
        # micro-batches split over the mesh's 'data' axis (its extent must divide max_batch)
        self.mesh = mesh
        if mesh is not None and self.max_batch % mesh.shape["data"]:
            raise ValueError(f"max_batch={self.max_batch} not divisible by the mesh data extent {mesh.shape['data']}")
        self._leading = False
        self._released = False
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batch_ids = itertools.count()

    # -- text front end ------------------------------------------------------

    def encode(self, text: str) -> np.ndarray:
        if self.phone_vocab is not None:
            seq = phones_to_sequence(text, self.phone_vocab)
        else:
            seq = text_to_sequence(text, self.cleaner_names)
        if not seq:
            raise ValueError(f"text encodes to an empty sequence: {text!r}")
        if len(seq) > self.max_t1:
            raise ValueError(f"text too long: {len(seq)} symbols > max_t1={self.max_t1}")
        return np.asarray(seq, np.int32)

    # -- synthesis -----------------------------------------------------------

    def synthesize_ids(self, seqs: list) -> list:
        """int32 id sequences -> float32 waveforms. With ``pipeline_fetch``
        each micro-batch's copy to the host overlaps the next one's
        dispatch."""
        out: list = [None] * len(seqs)

        def drain(lo, handle):
            for i, w in enumerate(self._fetch_batch(handle)):
                out[lo + i] = w

        pending = None
        for lo in range(0, len(seqs), self.max_batch):
            handle = self._dispatch_batch(seqs[lo: lo + self.max_batch])
            if self.pipeline_fetch:
                if pending is not None:
                    drain(*pending)
                pending = (lo, handle)
            else:
                drain(lo, handle)
        if pending is not None:
            drain(*pending)
        return out

    def synthesize(self, texts: list) -> list:
        return self.synthesize_ids([self.encode(t) for t in texts])

    def batch_bucket(self, n: int) -> int:
        """The batch size a micro-batch of n utterances is padded to: the next
        power of two, at most ``max_batch`` (``max_batch`` itself without
        ``batch_bucketing``)."""
        bb = self.max_batch if not self.batch_bucketing else 1
        while bb < n:
            bb *= 2
        return self._data_multiple(min(bb, self.max_batch))

    def _data_multiple(self, bb: int) -> int:
        """bb rounded up to a multiple of the mesh's data extent (at most
        ``max_batch``), so that the batch splits over it."""
        if self.mesh is None:
            return bb
        d = self.mesh.shape["data"]
        return min(-(-bb // d) * d, self.max_batch)

    def _dispatch_batch(self, seqs: list) -> _BatchHandle:
        """Pad and bucket a micro-batch and dispatch it, without waiting for
        the waveform. The engine lock is held for the dispatch only: stage 1
        with its readback of the lengths (which picks the mel bucket) and
        queueing stage 2 and the copy to the host."""
        n = len(seqs)
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        t1 = min(bucket_length(int(lengths.max()), self.t1_multiple), self.max_t1)
        # dummy rows of length 1 (pad symbol) fill the batch bucket; masks zero
        # their contribution and they are dropped before returning, so a
        # partly filled batch pays for its own bucket, not max_batch's
        bb = self.batch_bucket(n)
        text = np.zeros((bb, t1), np.int32)
        for i, s in enumerate(seqs):
            text[i, : len(s)] = s
        full_lengths = np.ones((bb,), np.int32)
        full_lengths[:n] = lengths
        return self._dispatch(text, full_lengths, n)

    def _dispatch(self, text: np.ndarray, lengths: np.ndarray, n: int) -> _BatchHandle:
        """Dispatch a padded micro-batch whose first n rows are requests."""
        timings: dict = {}
        batch = next(self._batch_ids)
        with span("engine.dispatch", batch=batch):
            t0 = time.perf_counter()
            with self._lock:
                t_lock = time.perf_counter()
                if self._released:
                    raise RuntimeError("this engine released its followers and dispatches no more batches")
                if self._leading:
                    self._broadcast(torch.tensor([*text.shape, 0], dtype=torch.int64, device=self.device))
                    for a in (text, lengths):
                        self._broadcast(torch.as_tensor(a, dtype=torch.int64, device=self.device))
                wav, wav_lengths = pipeline.synthesize_dispatch(
                    self.model, self.vocoder, text, lengths,
                    bucket_multiple=self.t2_multiple, max_t2=self.max_t2, compute_dtype=self.compute_dtype,
                    mrf_impl=self.mrf_impl, output="pcm16" if self.pcm16_transfer else "f32",
                    timings=timings, device=self.device, mesh=self.mesh)
                if self.detailed_timing and self.device.type == "cuda":
                    # attribution mode: wait for the device so the fetch measures the copy alone
                    t_d = time.perf_counter()
                    torch.cuda.synchronize(self.device)
                    timings["device_block_s"] = time.perf_counter() - t_d
        timings["lock_wait_s"] = t_lock - t0
        return _BatchHandle(wav=wav, wav_lengths=wav_lengths, n=n, t0=t0, timings=timings, batch=batch)

    def _fetch_batch(self, handle: _BatchHandle) -> list:
        """Fetch a dispatched micro-batch's waveforms (no engine lock). Each
        row is copied out of the batch's pinned buffer, which is released
        here: a served waveform does not keep the whole batch alive."""
        with span("engine.fetch", batch=handle.batch):
            t_f = time.perf_counter()
            wav = pipeline.fetch(handle.wav)
            fetch_s = time.perf_counter() - t_f
            wavs = []
            for i in range(handle.n):
                w = wav[i, : int(handle.wav_lengths[i])]
                if w.dtype == np.int16:
                    # exactly the device's quantization: re-encoding to WAV
                    # (round) gives the same PCM bytes
                    w = w.astype(np.float32) / 32767.0
                else:
                    w = np.array(w)
                wavs.append(w)
        handle.wav = None
        t = handle.timings
        sr = self.voc_cfg.sampling_rate
        with self._stats_lock:
            s = self.stats
            s.requests += handle.n
            s.batches += 1
            s.batch_sizes.append(handle.n)
            s.audio_seconds += sum(len(w) for w in wavs) / sr
            s.compute_seconds += time.perf_counter() - handle.t0
            s.lock_wait_seconds += t.get("lock_wait_s", 0.0)
            s.stage1_seconds += t.get("stage1_s", 0.0)
            s.dispatch_seconds += t.get("dispatch_s", 0.0)
            s.fetch_seconds += fetch_s
            s.device_seconds += t.get("device_block_s", 0.0)
        return wavs

    def _run_batch(self, seqs: list) -> list:
        """Dispatch and fetch one micro-batch (warmup, tests)."""
        return self._fetch_batch(self._dispatch_batch(seqs))

    def stream(self, text: str, chunk_frames: int = 64, overlap_frames: int = 24):
        """Yield float32 waveform chunks of one utterance.

        The time to the first audio is one mel decode and one small vocoder
        window: the text is decoded to a mel at ``max_t2`` (stages 1 and 2),
        trimmed on the host to a 32-frame bucket of its true length, then
        vocoded window by window (`pipeline.stream_vocoder`, whose interiors
        equal the full pass with overlap_frames >= 24). Only the decode holds
        the engine lock, so the windows interleave with batch traffic."""
        seq = self.encode(text)
        t1 = min(bucket_length(len(seq), self.t1_multiple), self.max_t1)
        text_ids = np.zeros((1, t1), np.int32)
        text_ids[0, : len(seq)] = seq
        lengths = np.asarray([len(seq)], np.int32)

        t0 = time.perf_counter()
        with self._lock:
            mel, mel_len = pipeline.decode_mel_fixed(
                self.model, text_ids, lengths, self.max_t2, compute_dtype=self.compute_dtype, device=self.device)
            n_frames = int(mel_len[0])
        lb = min(bucket_length(n_frames, 32), self.max_t2)
        mel_host = mel[0, :lb].float().cpu().numpy()
        del mel

        hop = self.voc_cfg.hop_size
        remaining = n_frames * hop
        for piece in pipeline.stream_vocoder(
                self.vocoder, mel_host, chunk_frames=chunk_frames, overlap_frames=overlap_frames,
                compute_dtype=self.compute_dtype, mrf_impl=self.mrf_impl, device=self.device):
            if remaining <= 0:
                break
            piece = piece[: max(remaining, 0)]
            remaining -= len(piece)
            if len(piece):
                yield piece
        dt = time.perf_counter() - t0
        with self._stats_lock:
            s = self.stats
            s.requests += 1
            s.batches += 1
            s.batch_sizes.append(1)
            s.audio_seconds += n_frames * hop / self.voc_cfg.sampling_rate
            s.compute_seconds += dt

    def warmup_batch_buckets(self) -> list:
        """The batch buckets the dispatcher emits: powers of two below
        ``max_batch``, then ``max_batch`` (only ``max_batch`` without
        ``batch_bucketing``)."""
        if not self.batch_bucketing:
            return [self.max_batch]
        buckets, bb = [], 1
        while bb < self.max_batch:
            buckets.append(bb)
            bb *= 2
        # under a mesh, the grid that rounding to the data extent gives
        return sorted({self._data_multiple(b) for b in buckets + [self.max_batch]})

    def warmup(self, t1_lengths=(16, 64), text_id: int = 1, batch_buckets=None, t2_neighbors: int = 1) -> None:
        """Run the bucket grid the dispatcher serves once, before the first
        request: for each text length t1 and batch bucket, a dispatched and
        fetched batch of dummy text (its organic mel bucket t2), then
        ``t2_neighbors`` mel buckets on either side of it through
        `pipeline.synthesize_fixed`, which absorb the duration spread of
        real text at the same t1. The JAX engine compiles this grid; here it
        makes the kernels' first build, each MRF stage's kernel weights in
        the served dtype and the pinned-memory pool. Waits for the device
        at the end and resets the stats."""
        if batch_buckets is None:
            batch_buckets = self.warmup_batch_buckets()
        output = "pcm16" if self.pcm16_transfer else "f32"
        for t1 in t1_lengths:
            t1 = min(t1, self.max_t1)
            organic_t2 = None
            for nb in batch_buckets:
                seqs = [np.full((t1,), text_id, np.int32)] * nb
                handle = self._dispatch_batch(seqs)
                organic_t2 = int(handle.timings.get("t2", 0)) or None
                self._fetch_batch(handle)
            if not t2_neighbors or organic_t2 is None:
                continue
            # neighbouring t2 buckets at every batch bucket (stage 1 does not
            # depend on t2 and has run above)
            t2s = [organic_t2 + d * self.t2_multiple for d in range(-t2_neighbors, t2_neighbors + 1) if d != 0]
            t2s = sorted({min(max(t2, self.t2_multiple), self.max_t2) for t2 in t2s} - {organic_t2})
            t1b = min(bucket_length(t1, self.t1_multiple), self.max_t1)
            for nb in batch_buckets:
                text = np.full((nb, t1b), 0, np.int32)
                text[:, :t1] = text_id
                lengths = np.full((nb,), t1, np.int32)
                if self.mesh is not None:  # this rank's rows, as a dispatch gives them
                    text, lengths = split_batch(text, self.mesh), split_batch(lengths, self.mesh)
                for t2 in t2s:
                    pipeline.synthesize_fixed(
                        self.model, self.vocoder, text, lengths, t2, compute_dtype=self.compute_dtype,
                        mrf_impl=self.mrf_impl, output=output, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset_stats()

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = EngineStats()

    # -- serving over ranks --------------------------------------------------

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=self.mesh.root, group=self.mesh.group)
        return t

    def lead(self) -> None:
        """On the mesh's root rank (the one that serves): from now on each
        micro-batch this engine dispatches is first broadcast to the other
        ranks, a header (batch bucket, text bucket, stop flag), then the
        padded ids and lengths."""
        if self.mesh is None or self.mesh.rank != self.mesh.root:
            raise RuntimeError("only the root rank of a mesh leads")
        self._leading = True

    def follow(self) -> int:
        """On every other rank of the mesh: receive each micro-batch the
        leader dispatches and dispatch and fetch it alike, until the leader
        `release_followers`. Returns the number of batches followed."""
        n = 0
        while True:
            bb, t1, stop = self._broadcast(torch.zeros(3, dtype=torch.int64, device=self.device)).tolist()
            if stop:
                return n
            text = self._broadcast(torch.zeros((bb, t1), dtype=torch.int64, device=self.device))
            lengths = self._broadcast(torch.zeros(bb, dtype=torch.int64, device=self.device))
            self._fetch_batch(self._dispatch(text.cpu().numpy(), lengths.cpu().numpy(), 0))
            n += 1

    def release_followers(self) -> None:
        """Broadcast the stop flag: the followers' `follow` returns. The
        engine dispatches nothing after it."""
        with self._lock:
            if self._leading and not self._released:
                self._broadcast(torch.tensor([0, 0, 1], dtype=torch.int64, device=self.device))
            self._released = True


class DynamicBatcher:
    """Coalesce concurrent single requests into engine micro-batches.

    `submit(text)` returns a `concurrent.futures.Future` resolving to a
    float32 waveform. A worker thread drains the queue: it blocks for the
    first request, then keeps gathering until ``max_batch`` requests are
    pending (``sort_ahead`` times that with a pipelined engine) or
    ``max_wait_ms`` has passed since the first one.
    """

    _STOP = object()

    def __init__(self, engine, max_batch: int | None = None, max_wait_ms: float = 10.0, pipeline_depth: int = 2,
                 sort_ahead: int = 3, max_queue: int | None = None, deadline_ms: float | None = None):
        self.engine = engine
        self.max_batch = max_batch or engine.max_batch
        self.max_wait = max_wait_ms / 1000.0
        # a pipelined engine gathers up to sort_ahead * max_batch requests a
        # window and sorts them by length before cutting micro-batches, so a
        # backlog makes full batches of like lengths at no added wait
        self.sort_ahead = max(1, int(sort_ahead))
        # Admission control: `max_queue` bounds the pending requests (submit
        # raises AdmissionError when full -> HTTP 503); `deadline_ms` bounds
        # the queue wait: a gathered request older than that is shed with
        # DeadlineExceededError instead of dispatched, so admitted traffic
        # waits about deadline + one batch at any offered load. Both are off
        # by default; the HTTP server turns them on.
        self.max_queue = max_queue
        self.deadline = deadline_ms / 1000.0 if deadline_ms else None
        self.shed_full = 0  # rejected at submit (queue full)
        self.shed_deadline = 0  # shed after admission (aged out)
        # submit runs on many handler threads at once, the shedding on the
        # gather thread: both counters change under this lock
        self._shed_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=max_queue or 0)
        self._request_ids = itertools.count()  # on the requests' `serve.queue` spans
        # dispatch -> fetch pipeline: the gather thread dispatches batches and
        # hands them to a fetch thread, so batch k's copy to the host
        # overlaps batch k+1's dispatch and device time; pipeline_depth bounds
        # the batches dispatched ahead. An engine without the dispatch/fetch
        # split (a duck type with synthesize_ids only) runs serially.
        self._pipelined = (
            getattr(engine, "pipeline_fetch", False)
            and hasattr(engine, "_dispatch_batch")
            # one gathered batch must fit one engine micro-batch
            and self.max_batch <= getattr(engine, "max_batch", 0)
        )
        self._fetch_q: queue.Queue = queue.Queue(maxsize=max(1, pipeline_depth))
        self._fetch_thread = None
        if self._pipelined:
            self._fetch_thread = threading.Thread(target=self._fetch_loop, daemon=True)
            self._fetch_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def shed_counts(self) -> tuple[int, int]:
        """(shed_full, shed_deadline), read together."""
        with self._shed_lock:
            return self.shed_full, self.shed_deadline

    def submit(self, text: str) -> Future:
        fut: Future = Future()
        item = (text, fut, time.perf_counter(), next(self._request_ids))
        if self.max_queue:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                with self._shed_lock:
                    self.shed_full += 1
                raise AdmissionError(f"request queue full ({self.max_queue} pending)") from None
        else:
            self._q.put(item)
        return fut

    def _post_stop(self) -> None:
        """Put the stop sentinel without blocking: while the bounded queue is
        full, take a pending request out and fail it."""
        while True:
            try:
                self._q.put_nowait(self._STOP)
                return
            except queue.Full:
                pass
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                continue
            if item is not self._STOP:
                item[1].set_exception(AdmissionError("the batcher is closing"))

    def close(self) -> None:
        self._post_stop()
        self._thread.join(timeout=5)
        if self._fetch_thread is not None:
            self._fetch_thread.join(timeout=5)

    def _gather(self):
        with span("serve.gather"):
            first = self._q.get()
            if first is self._STOP:
                return None
            items = [first]
            limit = self.max_batch * (self.sort_ahead if self._pipelined else 1)
            deadline = time.perf_counter() + self.max_wait
            while len(items) < limit:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._post_stop()  # again, for the outer loop
                    break
                items.append(nxt)
            return items

    def _length_groups(self, items: list, ratio: float = 0.7) -> list:
        """Split a chunk sorted by descending length into groups whose padded
        cost (batch bucket x length bucket) is lower than the one mixed
        batch's; mel frames scale with the symbol count, so the symbol count
        is the cost. Returns the groups of items."""
        if len(items) <= 1:
            return [items]
        groups = [[items[0]]]
        for it in items[1:]:
            if len(it[0]) < ratio * len(groups[-1][0][0]):
                groups.append([it])
            else:
                groups[-1].append(it)
        if len(groups) == 1:
            return groups

        def pow2(n):
            b = 1
            while b < n:
                b *= 2
            return b

        m = getattr(self.engine, "t1_multiple", 16)

        def cost(gs):
            return sum(pow2(len(g)) * (-(-len(g[0][0]) // m)) for g in gs)

        merged = [groups[0]]
        for g in groups[1:]:
            if cost([merged[-1] + g]) <= cost([merged[-1], g]):
                merged[-1] = merged[-1] + g
            else:
                merged.append(g)
        return merged

    def _loop(self) -> None:
        while True:
            items = self._gather()
            if items is None:
                if self._fetch_thread is not None:
                    self._fetch_q.put(self._STOP)
                return
            # a request that already waited past its deadline gets a fast 503
            # instead of aging further in a batch
            if self.deadline is not None:
                now = time.perf_counter()
                fresh = []
                for text, fut, ts, request in items:
                    waited = now - ts
                    if waited > self.deadline:
                        with self._shed_lock:
                            self.shed_deadline += 1
                        fut.set_exception(DeadlineExceededError(
                            f"queue wait {waited * 1e3:.0f} ms exceeded deadline {self.deadline * 1e3:.0f} ms"))
                    else:
                        fresh.append((text, fut, ts, request))
                items = fresh
                if not items:
                    continue
            # encode each request alone, so a bad text fails only its own future
            good: list = []
            for text, fut, ts, request in items:
                try:
                    good.append((self.engine.encode(text), fut, ts, request))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
            if not good:
                continue
            if self._pipelined:
                # every row of a micro-batch is synthesized and copied at the
                # batch's mel bucket, so a short row beside a long one pays
                # the long one's bytes: sort by length, cut micro-batches and
                # split what spread is left into groups of like lengths
                good.sort(key=lambda it: len(it[0]), reverse=True)
                for lo in range(0, len(good), self.max_batch):
                    for group in self._length_groups(good[lo: lo + self.max_batch]):
                        futs = [f for _, f, _, _ in group]
                        try:
                            handle = self.engine._dispatch_batch([s for s, _, _, _ in group])
                        except Exception as e:  # noqa: BLE001
                            for f in futs:
                                f.set_exception(e)
                            continue
                        for _, _, ts, request in group:  # submit -> the micro-batch's dispatch
                            mark("serve.queue", ts * 1e9, handle.t0 * 1e9, batch=handle.batch, request=request)
                        self._fetch_q.put((handle, futs))
                continue
            futs = [f for _, f, _, _ in good]
            try:
                wavs = self.engine.synthesize_ids([s for s, _, _, _ in good])
            except Exception as e:  # noqa: BLE001 - each request gets the error
                for f in futs:
                    f.set_exception(e)
                continue
            for f, w in zip(futs, wavs):
                f.set_result(w)

    def _fetch_loop(self) -> None:
        while True:
            item = self._fetch_q.get()
            if item is self._STOP:
                return
            handle, futs = item
            with span("serve.deliver", batch=handle.batch):
                try:
                    wavs = self.engine._fetch_batch(handle)
                except Exception as e:  # noqa: BLE001
                    for f in futs:
                        f.set_exception(e)
                    continue
                for f, w in zip(futs, wavs):
                    f.set_result(w)


def make_http_server(engine, host: str = "0.0.0.0", port: int = 8080, max_wait_ms: float = 10.0,
                     max_request_bytes: int = 1 << 20, max_queue: int | None = 256,
                     deadline_ms: float | None = 10_000.0):
    """Build (without starting) a ThreadingHTTPServer around the engine.

    Endpoints:
      POST /synthesize          {"text": "..."}   -> audio/wav
      POST /synthesize_stream   {"text": "..."}   -> chunked raw PCM_16
           (headers X-Sample-Rate and X-Audio-Format: pcm_s16le; the first
           chunk comes after one vocoder window, not the whole utterance)
      GET  /healthz                               -> {"ok": true}
      GET  /stats                                 -> engine counters and
                                                     the shed counters

    Errors: malformed JSON, a missing, non-string or empty `text`, a body
    over ``max_request_bytes`` and text the front end rejects (empty
    encoding, more than max_t1 symbols) are client errors (400 / 413);
    overload (queue full at admission, or a queue wait past
    ``deadline_ms``) is 503 with Retry-After; only unexpected engine
    failures give 500. ``max_queue=None`` / ``deadline_ms=None`` turn the
    bounds off.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = DynamicBatcher(engine, max_wait_ms=max_wait_ms, max_queue=max_queue, deadline_ms=deadline_ms)
    sr = engine.voc_cfg.sampling_rate

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # needed for chunked streaming

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict, headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                d = engine.stats.as_dict()
                d["shed_queue_full"], d["shed_deadline"] = batcher.shed_counts()
                self._json(200, d)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_stream"):
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if n > max_request_bytes:
                # reject before reading an oversized body
                self._json(413, {"error": f"request body {n} bytes > limit {max_request_bytes}"})
                self.close_connection = True
                return
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if not isinstance(text, str) or not text.strip():
                self._json(400, {"error": "'text' must be a non-empty string"})
                return
            if self.path == "/synthesize_stream":
                self._stream(text)
                return
            try:
                wav = batcher.submit(text).result(timeout=120)
            except AdmissionError as e:  # overload: shed, and say when to retry
                self._json(503, {"error": str(e)}, {"Retry-After": "1"})
                return
            except ValueError as e:  # front-end rejection: a client error
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})
                return
            body = encode_wav_bytes(wav, sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, text: str) -> None:
            try:
                chunks = engine.stream(text)
                first = next(chunks)  # validate before committing to 200
            except ValueError as e:  # front-end rejection: a client error
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Audio-Format", "pcm_s16le")
            self.send_header("X-Sample-Rate", str(sr))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(wav_piece: np.ndarray) -> None:
                pcm = np.clip(wav_piece, -1.0, 1.0)
                data = (pcm * 32767.0).astype("<i2").tobytes()
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            try:
                write_chunk(first)
                for piece in chunks:
                    write_chunk(piece)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                log.debug("stream client disconnected")

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # for shutdown
    return server


def serve_forever(server) -> None:
    log.info("serving on %s:%d", *server.server_address)
    try:
        server.serve_forever()
    finally:
        server.batcher.close()
        server.server_close()
