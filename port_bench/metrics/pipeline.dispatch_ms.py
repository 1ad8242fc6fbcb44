"""Host ms a batch spent queueing stage 2 and its copy (`synthesize_dispatch` timings["dispatch_s"])."""


def read(record):
    values = record.get("dispatch_s")
    return 1e3 * sum(values) / len(values) if values else None
