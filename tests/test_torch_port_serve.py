"""The port's serving layer (`efficient_tts_tpu_torch/serve.py`) on the CPU.

Against the JAX engine on the same seeded weights (`init.py` trees, folded
by each package): waveforms of `synthesize` at max_batch=2 over 3 texts (two
micro-batches, batch buckets 2 and 1) agree to atol 1e-5 in f32 and within
one PCM16 step with `pcm16_transfer`; `stream` to atol 1e-5; the batch
bucket of every n, the batcher's length groups, the stats' keys and the
warmup grid equal the JAX engine's. The rest runs the port alone: padding
invariance, the admission / deadline / HTTP contract of
`tests/test_serve_admission.py` and `tests/test_serve_robustness.py`, and
the counters and `close()` under threads. The sizes are
`tests/test_serve.py`'s (EFTS 32 channels, one layer each; HiFi-GAN 32
initial channels, one ResBlock1 branch of dilations (1, 2)).
"""

import dataclasses
import io
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu import serve as jserve
from efficient_tts_tpu.models.efficient_tts import EftsCNNConfig as JEftsCNNConfig
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.nn.layers import fold_weight_norm
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch import pipeline as tpipe
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.serve import (AdmissionError, DeadlineExceededError, DynamicBatcher, EngineStats,
                                           TTSEngine, make_http_server)

WAV_ATOL = 1e-5
PCM_STEP = 1.0 / 32767.0
EFTS_CFG = EftsCNNConfig(num_symbols=148, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=1,
                         n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=32,
                        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))
TEXTS = ["Hello there.", "A much longer sentence to synthesize, really.", "Hi."]


@pytest.fixture(scope="module")
def params():
    return init.init_efts(0, EFTS_CFG), init.init_generator(1, VOC_CFG)


@pytest.fixture(scope="module")
def models(params):
    ep, vp = params
    return compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu"), compat.hifigan_generator_from_jax(vp, VOC_CFG,
                                                                                                   device="cpu")


def _port(models, **kw):
    kw = {"max_batch": 2, "t2_multiple": 32, **kw}
    return TTSEngine(*models, device="cpu", **kw)


def _jax(params, **kw):
    ep, vp = params
    kw = {"max_batch": 2, "t2_multiple": 32, **kw}
    return jserve.TTSEngine(fold_weight_norm(ep), fold_weight_norm(vp),
                            JEftsCNNConfig(**dataclasses.asdict(EFTS_CFG)),
                            JHiFiGANConfig(**dataclasses.asdict(VOC_CFG)), **kw)


# ---------------------------------------------------------------------------
# against the JAX engine


@pytest.mark.parametrize("pcm16", [False, True])
def test_synthesize_matches_jax_engine(params, models, pcm16):
    port, ref = _port(models, pcm16_transfer=pcm16), _jax(params, pcm16_transfer=pcm16)
    got, want = port.synthesize(TEXTS), ref.synthesize(TEXTS)
    assert [len(w) for w in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.ndim == 1 and len(g) % VOC_CFG.hop_size == 0
        # f32: sums in another order; pcm16: a rounding of the device
        # quantization may flip, one step at most
        np.testing.assert_allclose(g, w, rtol=0, atol=PCM_STEP * 1.0001 if pcm16 else WAV_ATOL)
    # 3 texts at max_batch=2: two micro-batches
    assert port.stats.batches == 2 and port.stats.requests == 3
    assert port.stats.batch_sizes == ref.stats.batch_sizes == [2, 1]


def test_stream_matches_jax_engine(params, models):
    text = "A reasonably long sentence for streaming synthesis to chunk up."
    port, ref = _port(models, max_t2=512), _jax(params, max_t2=512)
    got = list(port.stream(text, chunk_frames=4, overlap_frames=4))
    want = list(ref.stream(text, chunk_frames=4, overlap_frames=4))
    assert [len(p) for p in got] == [len(p) for p in want] and len(got) > 1
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=WAV_ATOL)
    assert port.stats.requests == 1 and port.stats.batch_sizes == [1]


@pytest.mark.parametrize("max_batch, bucketing", [(5, True), (8, True), (5, False)])
def test_batch_bucket_matches_jax_engine(params, models, monkeypatch, max_batch, bucketing):
    """The batch size each n in 1..max_batch is padded to, as dispatched."""
    seen = {"port": [], "jax": []}

    def fake_dispatch(name):
        def dispatch(_model, _voc, text, lengths, *args, timings=None, **kw):
            seen[name].append(text.shape[0])
            return np.zeros((text.shape[0], 8), np.float32), np.full(text.shape[0], 8, np.int32)
        return dispatch

    monkeypatch.setattr(tpipe, "synthesize_dispatch", fake_dispatch("port"))
    monkeypatch.setattr(tpipe, "fetch", lambda wav: wav)
    monkeypatch.setattr(jpipe, "synthesize_dispatch", fake_dispatch("jax"))
    port = _port(models, max_batch=max_batch, batch_bucketing=bucketing)
    ref = _jax(params, max_batch=max_batch, batch_bucketing=bucketing)
    seq = np.ones(5, np.int32)
    for n in range(1, max_batch + 1):
        port._run_batch([seq] * n)
        ref._run_batch([seq] * n)
    assert seen["port"] == seen["jax"] == [port.batch_bucket(n) for n in range(1, max_batch + 1)]


def test_length_groups_match_jax_batcher():
    rng = np.random.default_rng(0)
    for t1_multiple in (8, 16):
        owner = types.SimpleNamespace(engine=types.SimpleNamespace(t1_multiple=t1_multiple))
        for _ in range(40):
            lengths = sorted(rng.integers(1, 200, rng.integers(1, 17)), reverse=True)
            items = [(np.ones(n, np.int32), i) for i, n in enumerate(lengths)]
            got = DynamicBatcher._length_groups(owner, items)
            want = jserve.DynamicBatcher._length_groups(owner, items)
            assert [[i for _, i in g] for g in got] == [[i for _, i in g] for g in want]


def test_engine_stats_keys_match_jax():
    assert list(EngineStats().as_dict()) == list(jserve.EngineStats().as_dict())
    s = EngineStats(requests=3, batches=2, audio_seconds=1.5, compute_seconds=0.25, batch_sizes=[2, 1])
    j = jserve.EngineStats(requests=3, batches=2, audio_seconds=1.5, compute_seconds=0.25, batch_sizes=[2, 1])
    assert s.as_dict() == j.as_dict()


def test_warmup_walks_the_jax_engine_grid(params, models, monkeypatch):
    """Every (batch, t1, t2) that warmup dispatches (t2 read from the
    dispatch's `timings["t2"]`) or runs at a fixed t2, against the JAX
    engine's on the same weights."""
    grids = {"port": [], "jax": []}
    inside = []  # the JAX dispatch calls synthesize_fixed itself: not an engine call

    def record_dispatch(name, real):
        def dispatch(_model, _voc, text, *args, timings=None, **kw):
            inside.append(1)
            try:
                out = real(_model, _voc, text, *args, timings=timings, **kw)
            finally:
                inside.pop()
            grids[name].append(("dispatch", text.shape[0], text.shape[1], timings["t2"]))
            return out
        return dispatch

    def record_fixed(name, real):
        def fixed(_model, _voc, text, lengths, *args, **kw):
            if not inside:
                t2 = kw.get("t2", args[2] if name == "jax" else args[0])
                grids[name].append(("fixed", text.shape[0], text.shape[1], int(t2)))
            return real(_model, _voc, text, lengths, *args, **kw)
        return fixed

    monkeypatch.setattr(tpipe, "synthesize_dispatch", record_dispatch("port", tpipe.synthesize_dispatch))
    monkeypatch.setattr(tpipe, "synthesize_fixed", record_fixed("port", tpipe.synthesize_fixed))
    monkeypatch.setattr(jpipe, "synthesize_dispatch", record_dispatch("jax", jpipe.synthesize_dispatch))
    monkeypatch.setattr(jpipe, "synthesize_fixed", record_fixed("jax", jpipe.synthesize_fixed))
    port, ref = _port(models), _jax(params)
    port.warmup(t1_lengths=(16,), t2_neighbors=1)
    ref.warmup(t1_lengths=(16,), t2_neighbors=1)
    assert grids["port"] == grids["jax"]
    assert {b for _, b, _, _ in grids["port"]} == {1, 2}
    assert sum(kind == "fixed" for kind, *_ in grids["port"]) >= 2
    # warmup resets the stats, as the JAX engine's
    assert port.stats.as_dict() == EngineStats().as_dict()


# ---------------------------------------------------------------------------
# the port alone


def test_padding_invariance_bit_for_bit(models):
    """A request gets the same audio whether its batch was padded to a
    power of two or to max_batch, and beside other utterances or alone."""
    ids = [np.asarray(x) for x in (_port(models).encode(t) for t in ("The same utterance.", "Another one entirely."))]
    bucketed = _port(models, max_batch=4)
    full = _port(models, max_batch=4, batch_bucketing=False)
    solo = bucketed.synthesize_ids([ids[0]])[0]
    np.testing.assert_array_equal(full.synthesize_ids([ids[0]])[0], solo)
    group = bucketed.synthesize_ids([ids[0], ids[1], ids[0]])
    np.testing.assert_array_equal(group[0], solo)
    np.testing.assert_array_equal(group[2], solo)
    np.testing.assert_array_equal(full.synthesize_ids([ids[0], ids[1], ids[0]])[1], group[1])


def test_fetched_rows_do_not_keep_the_batch_buffer(models):
    eng = _port(models, pcm16_transfer=False)
    handle = eng._dispatch_batch([eng.encode(t) for t in TEXTS[:2]])
    buf = handle.wav.wav
    wavs = eng._fetch_batch(handle)
    assert handle.wav is None
    for w in wavs:
        assert w.base is None and not np.shares_memory(w, buf.numpy())


def test_engine_rejects_bad_text_and_settings(models):
    eng = _port(models, max_t1=16)
    for bad in ("", "{}"):
        with pytest.raises(ValueError, match="empty"):
            eng.encode(bad)
    with pytest.raises(ValueError, match="too long"):
        eng.encode("far too long " * 20)
    with pytest.raises(ValueError, match="mrf_impl"):
        _port(models, mrf_impl="pallas")


class _GatedEngine:
    """Duck-typed engine whose synthesis blocks until released: a
    deterministic backlog without device timing."""

    max_batch = 4
    voc_cfg = VOC_CFG

    def __init__(self):
        self.gate = threading.Event()
        self.stats = EngineStats()

    def encode(self, text):
        return np.asarray([1] * max(len(text), 1), np.int32)

    def synthesize_ids(self, seqs):
        self.gate.wait(timeout=30)
        return [np.zeros(8, np.float32) for _ in seqs]


def test_bounded_queue_rejects_at_admission():
    eng = _GatedEngine()
    b = DynamicBatcher(eng, max_wait_ms=1.0, max_queue=3)
    futs = []
    try:
        with pytest.raises(AdmissionError):
            for _ in range(16):
                futs.append(b.submit("hello"))
        assert b.shed_counts()[0] >= 1
        eng.gate.set()
        # admitted requests still complete
        for f in futs:
            assert f.result(timeout=30) is not None
    finally:
        eng.gate.set()
        b.close()


def test_deadline_sheds_aged_requests():
    eng = _GatedEngine()
    b = DynamicBatcher(eng, max_wait_ms=1.0, deadline_ms=50.0)
    try:
        first = b.submit("first")
        time.sleep(0.1)
        aged = [b.submit(f"aged {i}") for i in range(4)]
        time.sleep(0.2)
        eng.gate.set()
        assert first.result(timeout=30) is not None
        for f in aged:
            with pytest.raises(DeadlineExceededError):
                f.result(timeout=30)
        assert b.shed_counts() == (0, len(aged))
    finally:
        eng.gate.set()
        b.close()


def test_shed_counter_under_eight_threads():
    """8 threads submit into a full queue at once: every AdmissionError is
    counted."""
    eng = _GatedEngine()
    b = DynamicBatcher(eng, max_wait_ms=1.0, max_queue=2)
    rejected, barrier, lock = [0], threading.Barrier(8), threading.Lock()
    futs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit_many():
            barrier.wait(10)
            for _ in range(500):
                try:
                    f = b.submit("x")
                    with lock:
                        futs.append(f)
                except AdmissionError:
                    with lock:
                        rejected[0] += 1

        threads = [threading.Thread(target=submit_many) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert rejected[0] > 0 and b.shed_counts() == (rejected[0], 0)
    finally:
        sys.setswitchinterval(interval)
        eng.gate.set()
        b.close()


def test_close_returns_with_a_full_bounded_queue():
    """close() puts its stop sentinel without blocking: with the gather thread
    held and the queue full, a pending request is failed to make room."""
    eng = _GatedEngine()
    b = DynamicBatcher(eng, max_wait_ms=1.0, max_queue=2, pipeline_depth=1)
    first = b.submit("first")
    time.sleep(0.1)  # the gather thread takes it and blocks in synthesis
    pending = [b.submit("a"), b.submit("b")]
    with pytest.raises(AdmissionError):
        b.submit("c")
    closer = threading.Thread(target=b.close)
    closer.start()
    # the queue stays full while the gate is shut: close must not wait for room
    deadline = time.time() + 5
    while not pending[0].done() and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(AdmissionError, match="closing"):
        pending[0].result(timeout=0)
    eng.gate.set()
    closer.join(10)
    assert not closer.is_alive()
    assert first.result(timeout=10) is not None


def test_stream_stats_counted_under_threads(models):
    eng = _port(models, max_t2=256)
    barrier, errors = threading.Barrier(8), []

    def run():
        try:
            barrier.wait(10)
            assert sum(len(p) for p in eng.stream("Hi there.")) > 0
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert eng.stats.requests == eng.stats.batches == 8 and eng.stats.batch_sizes == [1] * 8


def test_batcher_isolates_bad_request(models):
    """One invalid text in a coalesced batch fails only its own future."""
    batcher = DynamicBatcher(_port(models, max_batch=4, max_t1=16), max_wait_ms=200.0)
    try:
        good1 = batcher.submit("ok text")
        bad = batcher.submit("far too long " * 20)
        good2 = batcher.submit("also ok")
        for f in (good1, good2):
            w = f.result(timeout=120)
            assert isinstance(w, np.ndarray) and len(w) > 0
        with pytest.raises(ValueError):
            bad.result(timeout=120)
    finally:
        batcher.close()


def test_concurrent_stream_and_batch(models):
    """A stream and batch requests share the engine and give the audio they
    give alone."""
    eng = _port(models, max_t1=64)
    solo_stream = np.concatenate(list(eng.stream("Concurrent hello.")))
    solo_batch = eng.synthesize(["Another sentence."])[0]
    stream_out, errors = [], []

    def run_stream():
        try:
            stream_out.extend(eng.stream("Concurrent hello."))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=run_stream)
    t.start()
    batch_wav = eng.synthesize(["Another sentence."])[0]
    t.join(300)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(np.concatenate(stream_out), solo_stream)
    np.testing.assert_array_equal(batch_wav, solo_batch)


# ---------------------------------------------------------------------------
# HTTP


def _post(base, path, data: bytes, timeout=120):
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read(), dict(e.headers)


def _serve(engine, **kw):
    srv = make_http_server(engine, host="127.0.0.1", port=0, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, t):
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()
    t.join(timeout=5)


@pytest.fixture(scope="module")
def server(models):
    eng = _port(models, max_t1=64)
    srv, t, base = _serve(eng, max_wait_ms=5.0, max_request_bytes=4096)
    yield eng, base
    _stop(srv, t)


def test_http_roundtrip_matches_engine(server):
    eng, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True
    code, body, headers = _post(base, "/synthesize", json.dumps({"text": "Hello server."}).encode())
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == VOC_CFG.sampling_rate and w.getsampwidth() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    direct = eng.synthesize(["Hello server."])[0]
    # the served PCM is the engine's own quantization
    np.testing.assert_array_equal(pcm, np.round(np.clip(direct, -1, 1) * 32767).astype(np.int16))
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert set(stats) == set(EngineStats().as_dict()) | {"shed_queue_full", "shed_deadline"}
    assert stats["shed_queue_full"] == stats["shed_deadline"] == 0


@pytest.mark.parametrize("path, payload, code", [
    ("/synthesize", b"{not json", 400),
    ("/synthesize", b"{}", 400),
    ("/synthesize", b"[1, 2]", 400),
    ("/synthesize", json.dumps({"text": 7}).encode(), 400),
    ("/synthesize", json.dumps({"text": ["a"]}).encode(), 400),
    ("/synthesize", json.dumps({"text": None}).encode(), 400),
    ("/synthesize", json.dumps({"text": "  "}).encode(), 400),
    ("/synthesize", json.dumps({"text": "a b c " * 40}).encode(), 400),  # > max_t1 symbols
    ("/synthesize", json.dumps({"text": "x" * 8000}).encode(), 413),  # > max_request_bytes
    ("/synthesize_stream", json.dumps({"text": "a" * 200}).encode(), 400),
    ("/nowhere", b"{}", 404),
])
def test_http_error_contract(server, path, payload, code):
    _, base = server
    got, body, _ = _post(base, path, payload)
    assert got == code and b"error" in body


def test_http_unknown_get_is_404_and_server_stays_healthy(server):
    _, base = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nowhere", timeout=30)
    e.value.close()
    assert e.value.code == 404
    code, body, _ = _post(base, "/synthesize", json.dumps({"text": "Still fine."}).encode())
    assert code == 200
    with wave.open(io.BytesIO(body)) as w:
        assert w.getnframes() > 0


def test_http_stream_headers_and_audio(server):
    eng, base = server
    text = "Streaming over HTTP with chunked transfer encoding."
    code, raw, headers = _post(base, "/synthesize_stream", json.dumps({"text": text}).encode())
    assert code == 200 and headers["X-Audio-Format"] == "pcm_s16le"
    assert int(headers["X-Sample-Rate"]) == VOC_CFG.sampling_rate
    assert headers["Transfer-Encoding"] == "chunked"
    pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    streamed = np.concatenate(list(eng.stream(text)))
    np.testing.assert_array_equal(pcm, (np.clip(streamed, -1, 1) * 32767.0).astype("<i2") / np.float32(32767.0))


def test_http_503_with_retry_after_and_shed_stats():
    eng = _GatedEngine()
    srv, t, base = _serve(eng, max_queue=1, deadline_ms=None)
    codes, lock = [], threading.Lock()
    try:
        def post():
            got, _, headers = _post(base, "/synthesize", json.dumps({"text": "hello world"}).encode())
            with lock:
                codes.append((got, headers.get("Retry-After")))

        threads = [threading.Thread(target=post) for _ in range(8)]
        for th in threads:
            th.start()
        # the gather thread holds at most max_batch = 4 and the queue 1: at
        # least 3 of the 8 are shed while the gate is shut
        deadline = time.time() + 10
        while sum(c == 503 for c, _ in codes) < 3 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)
        eng.gate.set()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        shed = [ra for c, ra in codes if c == 503]
        assert len(codes) == 8 and len(shed) >= 3 and {c for c, _ in codes} == {200, 503}, codes
        assert all(ra == "1" for ra in shed)
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["shed_queue_full"] == len(shed) and stats["shed_deadline"] == 0
    finally:
        eng.gate.set()
        _stop(srv, t)


# ---------------------------------------------------------------------------
# the load bench's arm (`bench/serving_load.py`), on the small engine


def test_load_bench_arm_rows(models):
    from efficient_tts_tpu_torch.bench import serving_load

    eng = _port(models, max_batch=4)
    rng = np.random.default_rng(0)
    row = serving_load.run_load(eng, qps=40.0, duration_s=0.5, rng=rng, max_queue=64, deadline_ms=5000.0)
    assert row["offered"] > 0 and row["completed"] == row["offered"] and row["shed_pct"] == 0.0
    assert 0 < row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
    assert row["mean_batch"] >= 1 and row["audio_s_per_s"] > 0 and row["batches"] == eng.stats.batches
    assert set(row["per_batch_ms"]) == {"lock_wait", "stage1_readback", "dispatch", "device_compute", "wav_fetch",
                                        "total"}
    # every request shed: the percentiles are null, not an error
    shed = serving_load.run_load(eng, qps=40.0, duration_s=0.3, rng=rng, deadline_ms=1e-6)
    assert shed["offered"] > 0 and shed["completed"] == 0 and shed["shed_deadline"] == shed["offered"]
    assert shed["shed_pct"] == 100.0 and shed["p50_ms"] is shed["p95_ms"] is shed["p99_ms"] is None
    assert shed["mean_batch"] is None
    json.dumps(shed)
