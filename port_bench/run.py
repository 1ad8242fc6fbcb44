"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (weights from the seed, the program,
every shape of the cell's traffic warmed) counts as `setup_s`, from the
start of this module to the window's start. The window runs the cell's
traffic for `--seconds`. With `--trace 0` the result holds the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, read after the
same untraced window (host spans and counters, MFU) and a profiled stretch
of the same traffic (device time by kernel, idle share). Then the peak
memory is read, the program's state freed, and the reference checks what
the window produced: each number compared is printed beside its limit on
standard error and, last, in the result line under "check".

Exits 2 without a CUDA card (or fewer than the cell asks for), 3 if JAX or
the JAX package is loaded once the window has closed; neither prints a
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from port_bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "efficient_tts_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _device_dict(cell, torch, memory_peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": int(memory_peak)}


def execute(cell, seconds: float, trace: bool, t_start: float) -> dict:
    """Set up, run the window (and with `trace` the per-layer readings), read
    the peak memory, free the program and check. Returns the result line's
    fields but `device`, plus "memory_peak_bytes" and, with `trace`, the
    traced stretch's "busy_s" and "window_s"."""
    import torch

    from port_bench.reference.ops import Ops

    session = spec.driver(cell).Session(cell)
    setup_s = time.perf_counter() - t_start
    out = session.window(seconds)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {"attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        record = {"cell": cell.name, "config": cell.config, **out["record"], "trace": session.traced()}
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        from port_bench.record import breakdown

        result["breakdown"] = breakdown(record["trace"])
        result["busy_s"], result["window_s"] = record["trace"]["busy_s"], record["trace"]["window_s"]
    else:
        metrics = {name: {"value": v, "unit": units[name]} for name, v in out["e2e"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    result["metrics"] = metrics
    cuda = torch.device(cell.device).type == "cuda"
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    session.release()
    numbers = session.check(Ops(tf32=False))
    limits = cell.limits["limits"]
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    result["correct"] = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return result


def result_line(result: dict, device: dict, card: str) -> dict:
    """The result line: correct, attempted, failed, metrics, device, the
    card's name and power limit, the breakdown of a traced run, and last the
    numbers the check compared, each with its limit."""
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": device, "card": card}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    cell.seed = args.seed

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from port_bench.record import card_line

    card = card_line()
    result = execute(cell, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark and the port may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = _device_dict(cell, torch, result.pop("memory_peak_bytes"))
    if args.trace:
        device["busy_s"], device["window_s"] = result.pop("busy_s"), result.pop("window_s")
    line = result_line(result, device, card)
    for k, c in line["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
