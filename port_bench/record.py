"""A run's record: the benchmark's spans and counters, and the profiler's device trace reduced.

`profile(fn)` runs `fn` under `torch.profiler` (CPU and CUDA activity)
between two synchronizes, exports the Chrome trace to a temporary file
(under TMPDIR), reads it back and deletes it. What it keeps:

  * kernels: (name, start µs, duration µs) of every kernel, memcpy and
    memset on the device, and the number of kernel launches among them;
  * busy_s: the union of those intervals, and window_s, the traced
    stretch's length on the host clock;
  * idle gaps: the stretches between device intervals, each named by the
    deepest host event (a `record_function` span of the benchmark, or a
    PyTorch op) running at its middle.

`card_line` is `efficient_tts_tpu_torch/bench/__init__.py`'s, copied.
"""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile(fn) -> dict:
    """Trace `fn()` (its return value is kept as "result") and reduce the trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    with torch.profiler.profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce_trace(events, window_s)
    out["result"] = result
    return out


def reduce_trace(events: list, window_s: float) -> dict:
    """The device intervals, busy time and named idle gaps of a Chrome trace."""
    kernels, host, launches = [], [], 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            kernels.append((e.get("name", "?"), float(e["ts"]), float(e["dur"])))
            launches += cat == "kernel"
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")))
    kernels.sort(key=lambda k: k[1])
    merged = []
    for _, ts, dur in kernels:
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    busy_us = sum(b - a for a, b in merged)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps[_host_at(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    return {"kernels": kernels, "launches": launches, "busy_s": busy_us * 1e-6, "window_s": window_s,
            "idle_gaps": dict(gaps)}


def _host_at(host, starts, t, scan: int = 4000) -> str:
    """The host event with the latest start that covers time t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host idle"


def top(pairs: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: dict) -> dict:
    """The device ops that took most time and the idle gaps by host activity, 10 each."""
    by_op = defaultdict(float)
    for name, _, dur in trace["kernels"]:
        by_op[short_name(name)] += dur * 1e-6
    return {"device_ops": top(by_op), "idle_gaps": top(trace["idle_gaps"])}


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its argument list, cut to `limit` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]


def kernel_seconds(trace: dict, fragment: str) -> tuple[float, int]:
    """(seconds, launches) of the device ops whose name holds `fragment`."""
    hits = [dur for name, _, dur in trace["kernels"] if fragment in name]
    return sum(hits) * 1e-6, len(hits)
