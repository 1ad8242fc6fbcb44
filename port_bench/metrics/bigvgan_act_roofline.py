"""BigVGAN's anti-aliased activations against their bound, in %.

The bound is the least time of their bytes in the profiled stretch (one f32
read and one write a channel-sample at the 1x rate, each utterance at its
real length, over 3.35 TB/s: `work/bigvgan.py`); the time is the sum of
the `bigvgan.act` spans' device times there.
"""

from port_bench.spans import named, program_spans


def value(spans, bound_s):
    seconds = sum(s.device_ms for s in named(spans, "bigvgan.act") if s.device_ms is not None) / 1e3
    return 100.0 * bound_s / seconds if seconds > 0 and bound_s else None


def read(record):
    return value(program_spans(), record["trace"].get("bigvgan_act_bound_s"))
