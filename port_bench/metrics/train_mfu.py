"""Three forwards' FLOPs at the real lengths a step, over the window, against the TF32 peak, in %.

f32 convs outside the kernels run on the 67 TFLOP/s FP32 units, so this
stays low by construction.
"""

from port_bench.work.roofline import F32_PEAK, PEAK_FLOPS


def read(record):
    return 100.0 * record["flops"] / record["window_s"] / PEAK_FLOPS[F32_PEAK] if record.get("flops") else None
