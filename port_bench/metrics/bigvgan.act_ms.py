"""Device ms a batch spends in BigVGAN's anti-aliased activations: the `bigvgan.act`
spans' CUDA-event times summed, over the `bigvgan.generator` spans (one a batch)."""

from port_bench.spans import named, program_spans


def value(spans):
    acts = [s.device_ms for s in named(spans, "bigvgan.act") if s.device_ms is not None]
    batches = len(named(spans, "bigvgan.generator"))
    return sum(acts) / batches if acts and batches else None


def read(record):
    return value(program_spans())
