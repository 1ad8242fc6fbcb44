"""Synthesis FLOPs at the real lengths over the window's seconds, against the TF32 peak, in %."""

from port_bench.work.roofline import F32_PEAK, PEAK_FLOPS


def read(record):
    return 100.0 * record["flops"] / record["window_s"] / PEAK_FLOPS[F32_PEAK] if record.get("flops") else None
