"""Mean over the traced stretch's micro-batches of the time from the entry of
their dispatch (`engine.dispatch`) to the end of their delivery, the last of
their requests' futures resolved (`serve.deliver`), in ms."""

from port_bench.spans import mean, named, program_spans


def value(spans):
    delivered = {s.batch: s.end_ns for s in named(spans, "serve.deliver")}
    return mean([(delivered[s.batch] - s.start_ns) / 1e6 for s in named(spans, "engine.dispatch")
                 if s.batch in delivered])


def read(record):
    return value(program_spans())
