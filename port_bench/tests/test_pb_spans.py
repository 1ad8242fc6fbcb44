"""The readers of the port's spans (`metrics/*.py` over `spans.py`): their arithmetic
on hand-made span records, and nothing where no span was recorded or the port has none."""

import importlib.util
import sys
import types

import pytest
import torch

from efficient_tts_tpu_torch.utils.profiling import Span
from port_bench import spec
from port_bench.spans import program_spans

READERS = ("serve.queue_wait_p95_ms", "serve.batch_ms", "pipeline.readback_ms", "acoustic.device_ms",
           "vocoder.device_ms", "train.optimizer_ms")
MS = 1_000_000


def _value(name: str):
    path = spec.PACKAGE / "metrics" / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.value


def test_queue_wait_p95():
    waits = [Span("serve.queue", 0, k * MS, batch=k // 10, request=k) for k in range(1, 101)]
    noise = [Span("engine.dispatch", 0, 500 * MS, batch=0)]
    assert _value("serve.queue_wait_p95_ms")(waits + noise) == pytest.approx(95.05)


def test_batch_ms_from_dispatch_entry_to_delivery_end():
    spans = [Span("engine.dispatch", 10 * MS, 20 * MS, batch=0), Span("engine.fetch", 25 * MS, 38 * MS, batch=0),
             Span("serve.deliver", 24 * MS, 40 * MS, batch=0),
             Span("engine.dispatch", 30 * MS, 35 * MS, batch=1), Span("serve.deliver", 45 * MS, 50 * MS, batch=1),
             Span("engine.dispatch", 60 * MS, 61 * MS, batch=2)]  # never delivered in the stretch: left out
    assert _value("serve.batch_ms")(spans) == pytest.approx((30 + 20) / 2)


def test_readback_host_mean_and_optimizer_device_mean():
    spans = [Span("pipeline.readback", 0, 2 * MS), Span("pipeline.readback", 5 * MS, 9 * MS),
             Span("train.optimizer", 0, 300 * MS, device_ms=3.0), Span("train.optimizer", 0, 200 * MS, device_ms=5.0),
             Span("train.optimizer", 0, 100 * MS, device_ms=7.0)]
    assert _value("pipeline.readback_ms")(spans) == pytest.approx(3.0)
    assert _value("train.optimizer_ms")(spans) == pytest.approx(5.0)  # device time, not the host's 200 ms
    assert _value("train.optimizer_ms")([Span("train.optimizer", 0, MS)]) is None  # no CUDA events: a CPU run


def test_device_ms_of_the_acoustic_model_and_the_vocoder_per_batch():
    spans = [Span("pipeline.stage1", 0, 1, device_ms=4.0), Span("efts.decode", 0, 1, device_ms=10.0),
             Span("hifigan.generator", 0, 1, device_ms=100.0),
             Span("pipeline.stage1", 0, 1, device_ms=6.0), Span("efts.decode", 0, 1, device_ms=12.0),
             Span("hifigan.generator", 0, 1, device_ms=120.0),
             Span("hifigan.generator", 0, 1)]  # no CUDA events (a CPU run): left out
    assert _value("acoustic.device_ms")(spans) == pytest.approx((4 + 10 + 6 + 12) / 2)
    assert _value("vocoder.device_ms")(spans) == pytest.approx(110.0)
    assert _value("acoustic.device_ms")([Span("pipeline.stage1", 0, 1)]) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_spans(name):
    assert _value(name)([]) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass  # a profiled stretch that recorded no span
    assert program_spans() == []
    assert spec.metric_reader(name)({"trace": {}}) is None


def test_nothing_from_a_port_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "efficient_tts_tpu_torch.utils.profiling", types.ModuleType("no_spans"))
    assert program_spans() == []
    for name in READERS:
        assert spec.metric_reader(name)({"trace": {}}) is None
