"""Mean device ms a batch spends in the BigVGAN generator (`bigvgan.generator`), between its CUDA events."""

from port_bench.spans import mean, named, program_spans


def value(spans):
    return mean([s.device_ms for s in named(spans, "bigvgan.generator") if s.device_ms is not None])


def read(record):
    return value(program_spans())
