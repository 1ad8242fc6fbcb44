"""Launch counters of the kernel wrappers, safe to add to from several threads.

Each kernel module keeps a dict of launches by key (`ops/mrf.py:launches`
and the others); a wrapper adds one with `add` where it launches its kernel
(`ops/fused_adam.py` also counts leaves with it).
The serving engine launches from its batcher's threads and from HTTP
handler threads at once, and `d[k] = d.get(k, 0) + 1` is not atomic.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()


def add(counts: dict, key, n: int = 1) -> None:
    with _lock:
        counts[key] = counts.get(key, 0) + n
