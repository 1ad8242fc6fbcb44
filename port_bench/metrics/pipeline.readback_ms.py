"""Mean host ms a batch spends blocked on stage 1's readback of the mel lengths (`pipeline.readback`)."""

from port_bench.spans import mean, named, program_spans


def value(spans):
    return mean([s.ms for s in named(spans, "pipeline.readback")])


def read(record):
    return value(program_spans())
