"""Share of the profiled stretch in which no kernel, copy or memset ran on the device, in %
(nothing where no device op was traced)."""


def read(record):
    trace = record["trace"]
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"]) if trace["busy_s"] > 0 else None
