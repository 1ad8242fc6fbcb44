"""Kernel launches per training step in the profiled stretch."""


def read(record):
    steps = record["trace"].get("result")
    launches = record["trace"]["launches"]
    return launches / steps if steps and launches else None
