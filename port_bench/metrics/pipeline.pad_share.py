"""Share of the synthesized mel frames that are padding: 1 - real frames / (batch x bucket), in %."""


def read(record):
    padded = record.get("padded_frames")
    return 100.0 * (1.0 - record["real_frames"] / padded) if padded else None
