"""Readings that the limits of a cell's check are set from, in one process.

    python3 -m port_bench.tools.calibrate --workload <cell> --seeds 12 --control_seeds 3 --seconds 3

For each seed: the cell's set-up, a window of `--seconds`, the check
against the reference (the program's reading, the lower one). On the first
`--control_seeds` seeds also the control, the reference in TF32 put in the
program's place (the upper reading), and for a training cell the fault of
half of each batch left out, the mean taken over the rest. Each seed prints
one JSON line; the last line holds, per number, the largest program
reading, the smallest control reading and the smallest fault reading. The
seeds start at `--first_seed` and step by a large odd number, so they are
large and distinct. Runs on the card (`--device cpu` rehearses at the
cell's size on the CPU, which is slow).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import spec
from port_bench.reference.ops import Ops

STRIDE = 1_000_003


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first_seed", type=int, default=3_000_000_019)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leaves", action="store_true", help="a training cell's worst leaves too")
    args = ap.parse_args(argv)
    lower, control, fault = {}, {}, {}
    for n in range(args.seeds):
        cell = spec.load_cell(args.workload)
        cell.seed, cell.device = args.first_seed + n * STRIDE, args.device
        t0 = time.perf_counter()
        session = spec.driver(cell).Session(cell)
        out = session.window(args.seconds)
        session.release()
        line = {"seed": cell.seed, "attempted": out["attempted"], "e2e": out["e2e"],
                "program": session.check(Ops())}
        if args.leaves:
            line["program_leaves"] = session.worst_leaves(Ops())
        if n < args.control_seeds:
            if cell.traffic["driver"] == "train":
                half = session.plan[0]["text"].shape[0] // 2
                session.substitute(Ops(), rows=half)
                line["half_batch"] = session.check(Ops())
            session.substitute(Ops(tf32=True))
            line["control"] = session.check(Ops())
            if args.leaves:
                line["control_leaves"] = session.worst_leaves(Ops())
        line["seconds"] = time.perf_counter() - t0
        for name, value in line["program"].items():
            lower[name] = max(lower.get(name, 0.0), value)
        for key, store in (("control", control), ("half_batch", fault)):
            for name, value in line.get(key, {}).items():
                store[name] = min(store.get(name, float("inf")), value)
        print(json.dumps(line), flush=True)
        del session
    print(json.dumps({"workload": args.workload, "lower": lower, "control": control, "half_batch": fault}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
