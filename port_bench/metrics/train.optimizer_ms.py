"""Mean device ms a training step spends in the optimizer: global norm, clip, the update
(`train.optimizer`), between the span's CUDA events."""

from port_bench.spans import mean, named, program_spans


def value(spans):
    return mean([s.device_ms for s in named(spans, "train.optimizer") if s.device_ms is not None])


def read(record):
    return value(program_spans())
