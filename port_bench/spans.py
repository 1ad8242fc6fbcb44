"""The port's own spans of the latest profiled stretch, for the per-layer metrics that read them.

`efficient_tts_tpu_torch/utils/profiling.py` records a span at each layer
boundary while a torch profiler runs; the traced stretch of a run
(`record.profile`) is such a profiler, and it is the last one before the
metrics are read. A port without spans gives an empty list, and the
metrics that read them give nothing.
"""

from __future__ import annotations


def program_spans() -> list:
    try:
        from efficient_tts_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def mean(values: list) -> float | None:
    return sum(values) / len(values) if values else None
