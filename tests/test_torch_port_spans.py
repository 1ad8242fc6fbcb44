"""The port's spans (`efficient_tts_tpu_torch/utils/profiling.py`) on the CPU.

Without a profiler a span is the shared null context and records nothing.
Under `torch.profiler` spans are recorded with their parents and ids and,
on the profiling thread, show as `user_annotation` events; each session
starts a fresh buffer, and a full buffer drops its oldest records and
counts them. Through `DynamicBatcher` on a CPU engine at the serving
tests' widths, every `serve.queue` mark names a micro-batch with one
`engine.dispatch`, one `engine.fetch` and one `serve.deliver`, the
`pipeline.*` spans have those as parents, and a request's queue wait plus
its batch's span (dispatch to delivery) is its submit -> result time
within 1 ms. A CPU train step records its three spans once a step.
`trace` writes the queue marks into its Chrome trace on the trace's
clock, each ending at its dispatch's CPU ops.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.serve import DynamicBatcher, TTSEngine
from efficient_tts_tpu_torch.train.efts_train_step import make_train_step
from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
from efficient_tts_tpu_torch.train.state import create_state
from efficient_tts_tpu_torch.utils import profiling
from efficient_tts_tpu_torch.utils.profiling import mark, span, spans

EFTS_CFG = EftsCNNConfig(num_symbols=148, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=1,
                         n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=32,
                        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))
TEXTS = ["Hello there.", "A much longer sentence to synthesize, really.", "Hi.", "Three words here.",
         "Another sentence, of middling length.", "Short one."]
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def engine():
    model = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu")
    voc = compat.hifigan_generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    return TTSEngine(model, voc, device="cpu", max_batch=4, t2_multiple=32)


def _serve(engine, texts, wait_ms=5.0):
    """Submit `texts` from one thread a little apart; returns each request's
    (submit, result) perf_counter stamps once all are back."""
    batcher = DynamicBatcher(engine, max_wait_ms=wait_ms)
    stamps, done = {}, threading.Event()

    def finished(i, fut):
        stamps[i] = (stamps[i][0], time.perf_counter())
        if len(stamps) == len(texts) and all(len(v) == 2 and v[1] for v in stamps.values()):
            done.set()

    futs = []
    try:
        for i, text in enumerate(texts):
            stamps[i] = (time.perf_counter(), None)
            fut = batcher.submit(text)
            fut.add_done_callback(lambda f, i=i: finished(i, f))
            futs.append(fut)
            time.sleep(0.002 * (i % 3))
        for f in futs:
            assert f.result(timeout=120) is not None
        assert done.wait(30)
    finally:
        batcher.close()
    return stamps


def test_no_span_recorded_without_a_profiler():
    with torch.profiler.profile(activities=CPU):
        with span("probe.before"):
            pass
    before = spans()
    assert [s.name for s in before] == ["probe.before"]
    assert span("probe.off") is span("probe.other", batch=1, device=True)  # the shared null context
    with span("probe.off"):
        with span("probe.inner"):
            pass
    mark("probe.mark", 0, 10)
    assert spans() == before


def test_spans_recorded_under_the_profiler(tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        with span("probe.outer", batch=7):
            with span("probe.inner", request=3, device=True):
                torch.ones(4).sum()
            mark("probe.mark", 5, 25, batch=7, request=3)
    outer, inner, marked = spans("probe.outer"), spans("probe.inner"), spans("probe.mark")
    assert len(outer) == len(inner) == len(marked) == 1
    (outer,), (inner,), (marked,) = outer, inner, marked
    assert outer.parent is None and inner.parent == outer.id and marked.parent == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert (outer.batch, inner.request, marked.batch, marked.request) == (7, 3, 7, 3)
    assert (inner.device_ms is None) == (not torch.cuda.is_initialized())  # CUDA events only where CUDA runs
    assert marked.ms == pytest.approx(20e-6) and outer.thread == threading.get_native_id()
    assert [s.name for s in spans()] == ["probe.inner", "probe.mark", "probe.outer"]  # in the order they ended
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    annotations = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "user_annotation"}
    assert {"probe.outer", "probe.inner"} <= annotations


def test_each_session_starts_a_fresh_buffer_and_a_full_one_drops_the_oldest(monkeypatch):
    with torch.profiler.profile(activities=CPU):
        with span("probe.first"):
            pass
    assert [s.name for s in spans()] == ["probe.first"]
    with torch.profiler.profile(activities=CPU):
        with span("probe.second"):
            pass
    assert [s.name for s in spans()] == ["probe.second"] and profiling.dropped_spans() == 0
    monkeypatch.setattr(profiling, "_BUFFER", profiling._Buffer(4))
    with torch.profiler.profile(activities=CPU):
        for i in range(7):
            with span(f"probe.{i}"):
                pass
    assert [s.name for s in spans()] == [f"probe.{i}" for i in range(3, 7)]
    assert profiling.dropped_spans() == 3
    with torch.profiler.profile(activities=CPU):
        pass
    assert spans() == [] and profiling.dropped_spans() == 0


def test_batcher_spans_account_for_each_request(engine):
    with torch.profiler.profile(activities=CPU):
        stamps = _serve(engine, TEXTS)
    queue = spans("serve.queue")
    assert sorted(s.request for s in queue) == sorted(set(s.request for s in queue)) and len(queue) == len(TEXTS)
    by_name = collections.defaultdict(list)
    for s in spans():
        by_name[s.name].append(s)
    dispatch = {s.batch: s for s in by_name["engine.dispatch"]}
    fetch = {s.batch: s for s in by_name["engine.fetch"]}
    deliver = {s.batch: s for s in by_name["serve.deliver"]}
    assert len(dispatch) == len(by_name["engine.dispatch"]) and len(fetch) == len(by_name["engine.fetch"])
    assert len(deliver) == len(by_name["serve.deliver"])
    assert {s.batch for s in queue} == set(dispatch) == set(fetch) == set(deliver)
    assert by_name["serve.gather"]
    for name, parent in (("pipeline.upload", dispatch), ("pipeline.stage1", dispatch), ("pipeline.readback", dispatch),
                         ("pipeline.stage2", dispatch), ("pipeline.fetch", fetch), ("engine.fetch", deliver)):
        assert sorted(s.parent for s in by_name[name]) == sorted(p.id for p in parent.values())
    stage2 = {s.id for s in by_name["pipeline.stage2"]}
    assert {s.parent for s in by_name["efts.decode"]} == {s.parent for s in by_name["hifigan.generator"]} == stage2
    # a request's queue wait ends at its batch's dispatch; the batch's span runs until its futures are resolved
    for s in queue:  # request ids count the batcher's submits from 0
        (t_submit, t_result), d, f = stamps[s.request], dispatch[s.batch], deliver[s.batch]
        assert abs(s.end_ns - d.start_ns) < 1e6 and s.start_ns >= t_submit * 1e9
        total_ms = s.ms + (f.end_ns - d.start_ns) / 1e6
        assert total_ms == pytest.approx((t_result - t_submit) * 1e3, abs=1.0)


def test_train_step_records_its_three_spans_once_a_step():
    cfg = EftsCNNConfig(num_symbols=30, odim=20, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=1,
                        n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
    model = compat.efts_cnn_from_jax(init.init_efts(0, cfg), cfg, device="cpu", trainable=True)
    tx = optimizer_from_dict({"optimizer_params": {"lr": 1e-3}, "grad_norm": 1.0})
    step, state = make_train_step(cfg, tx, device="cpu"), create_state(model, tx)
    rng = np.random.default_rng(0)
    tl, ml = np.array([12, 7], np.int32), np.array([32, 20], np.int32)
    text = np.zeros((2, 12), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, cfg.num_symbols, n)
    mel = rng.standard_normal((2, 32, cfg.odim)).astype(np.float32) * (np.arange(32)[None, :, None] < ml[:, None, None])
    batch = {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            state, _ = step(state, batch)
    names = [s.name for s in spans()]
    assert names == ["train.forward", "train.backward", "train.optimizer"] * 2
    assert all(s.parent is None and s.ms > 0 for s in spans())


def test_trace_writes_the_queue_marks_on_its_clock(engine, tmp_path):
    with profiling.trace(str(tmp_path)):
        _serve(engine, TEXTS[:4])
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    begins = {e["id"]: e for e in events if e.get("name") == "serve.queue" and e.get("ph") == "b"}
    ends = {e["id"]: e for e in events if e.get("name") == "serve.queue" and e.get("ph") == "e"}
    queue = {s.id: s for s in spans("serve.queue")}
    assert set(begins) == set(ends) == set(queue) and len(queue) == 4
    # the batcher's gather thread is profiled: its dispatches are annotated, with their CPU ops
    annotated = sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"] == "engine.dispatch"),
                       key=lambda e: e["ts"])
    dispatch = sorted(spans("engine.dispatch"), key=lambda s: s.start_ns)
    assert len(annotated) == len(dispatch) and {e["tid"] for e in annotated} == {dispatch[0].thread}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    slot = {s.batch: a for s, a in zip(dispatch, annotated)}
    for i, s in queue.items():
        assert begins[i]["args"] == ends[i]["args"] == {"batch": s.batch, "request": s.request}
        assert ends[i]["ts"] - begins[i]["ts"] == pytest.approx(s.ms * 1e3, abs=1e-3)
        a = slot[s.batch]
        inside = [e["ts"] for e in ops if e["tid"] == a["tid"] and a["ts"] <= e["ts"] <= a["ts"] + a["dur"]]
        assert inside
        # the mark ends where its dispatch starts, before the dispatch's first op, on the trace's clock
        assert a["ts"] - 500 <= ends[i]["ts"] <= min(inside) + 500
