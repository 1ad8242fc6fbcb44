"""95th percentile of how late the generator sent each request after it was due, in ms."""

import numpy as np


def read(record):
    lag = record.get("lag_s")
    return 1e3 * float(np.percentile(lag, 95)) if lag else None
