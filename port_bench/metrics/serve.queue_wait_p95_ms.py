"""95th percentile over the traced stretch's requests of their wait in the
batcher's queue, from `submit` to their micro-batch's dispatch (`serve.queue`), in ms."""

import numpy as np

from port_bench.spans import named, program_spans


def value(spans):
    waits = [s.ms for s in named(spans, "serve.queue")]
    return float(np.percentile(waits, 95)) if waits else None


def read(record):
    return value(program_spans())
