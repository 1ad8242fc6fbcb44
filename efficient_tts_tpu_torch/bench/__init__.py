"""Card benchmarks, ports of the JAX package's scripts.

    python -m efficient_tts_tpu_torch.bench.mrf_fused      # scripts/bench_mrf_fused.py
    python -m efficient_tts_tpu_torch.bench.probe_int8     # scripts/probe_int8_pallas.py
    python -m efficient_tts_tpu_torch.bench.serving_load   # scripts/bench_serving_load.py
    python -m efficient_tts_tpu_torch.bench.fused_adam     # the fused optimizer against the per-tensor path

Each runs on the NVIDIA card and raises without one, and prints under the
card's name and power limit. The kernel benches' times are medians of
CUDA-event times of ITERS calls after WARMUP calls; the serving bench's are
request latencies on the host clock.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

ITERS, WARMUP = 20, 2


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """{"median", "p25", "p75", "n"} in ms of CUDA-event times of `iters`
    calls of `fn` after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return {"median": q2, "p25": q1, "p75": q3, "n": iters}
