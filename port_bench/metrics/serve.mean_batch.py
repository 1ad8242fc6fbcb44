"""Requests per micro-batch that the engine fetched in the window (`EngineStats.batch_sizes`)."""


def read(record):
    sizes = record.get("batch_sizes")
    return sum(sizes) / len(sizes) if sizes else None
