"""Host ms a micro-batch spent queueing stage 2 and its copy (`EngineStats.dispatch_seconds` over batches)."""


def read(record):
    batches = record.get("batches")
    return 1e3 * record["dispatch_s"] / batches if batches else None
