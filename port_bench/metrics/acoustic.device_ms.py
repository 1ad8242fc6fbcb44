"""Mean device ms a batch spends in the acoustic model: stage 1 (`pipeline.stage1`)
and the decoder (`efts.decode`), between each span's CUDA events."""

from port_bench.spans import named, program_spans


def value(spans):
    stage1 = [s.device_ms for s in named(spans, "pipeline.stage1") if s.device_ms is not None]
    decode = [s.device_ms for s in named(spans, "efts.decode") if s.device_ms is not None]
    return (sum(stage1) + sum(decode)) / len(stage1) if stage1 else None


def read(record):
    return value(program_spans())
