"""The f32 MRF kernel (K3, `mrf_conv_wgmma_tf32x3_kernel`) against its bound, in %.

The bound is the least time of the stages it ran in the profiled stretch,
at each utterance's real length (`work/roofline.py`); the time is the
device time of its launches there.
"""

from port_bench.record import kernel_seconds


def read(record):
    seconds, launches = kernel_seconds(record["trace"], "mrf_conv_wgmma_tf32x3")
    return 100.0 * record["trace"]["k3_bound_s"] / seconds if launches else None
