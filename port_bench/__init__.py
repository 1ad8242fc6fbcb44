"""The benchmark of the PyTorch and CUDA port (`efficient_tts_tpu_torch`).

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything here is the yardstick: traffic generation (`corpus.py`, the
drivers), seeded weights (`weights.py`), the reduction of spans, counters
and profiler traces to metrics (`record.py`, `metrics/`), the work counts
and peaks (`work/`) and the plain reference that decides `correct`
(`reference/`). From the port it takes only the system under test and its
counters. Nothing here imports JAX or the JAX package.
"""
