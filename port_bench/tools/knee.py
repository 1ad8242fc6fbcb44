"""The serving cell's knee: the highest offered rate that the engine sustains.

    python3 -m port_bench.tools.knee --workload cnn_serve_poisson --rates 60,80,100,120 --seconds 15

One set-up, then for each rate an open-loop arm of `--seconds` with the
cell's traffic at that rate. An arm is sustained when every request due in
it came back, none was shed, and the backlog did not grow through it: the
median latency of the requests due in its last fifth is at most 1.5 times
that of those due in its second fifth. Prints one JSON line an arm and the
knee, the highest sustained rate below the first arm that is not.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from port_bench import corpus, spec


def growth(latency: np.ndarray) -> float:
    """Median latency of the last fifth of the requests over that of the second fifth."""
    fifths = np.array_split(latency, 5)
    return float(np.median(fifths[4]) / max(np.median(fifths[1]), 1e-9)) if len(latency) >= 10 else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cnn_serve_poisson")
    ap.add_argument("--rates", default="60,80,100,120,140,160")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=4_000_000_007)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    cell.seed = args.seed
    session = spec.driver(cell).Session(cell)
    knee, failed = None, False
    for rate in (float(r) for r in args.rates.split(",")):
        n = len(session.gaps)
        session.gaps = corpus.planned(corpus.exponential_quantiles(n, 1.0 / rate), cell.traffic["plan_seed"])
        session.engine.reset_stats()
        r = session._run(args.seconds, keep=False)
        lat = r["latency"]
        g = growth(lat)
        sustained = bool(r["completed"].all() and g <= 1.5)
        stats = session.engine.stats
        line = {"rate": rate, "due": len(lat), "completed": int(r["completed"].sum()),
                "p50_ms": 1e3 * float(np.median(lat)), "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)), "growth": g,
                "mean_batch": float(np.mean(stats.batch_sizes)) if stats.batch_sizes else None,
                "lag_p95_ms": 1e3 * float(np.percentile(r["sent"] - r["due"], 95)), "sustained": sustained}
        print(json.dumps(line), flush=True)
        if sustained and not failed:
            knee = rate
        failed = failed or not sustained
    print(json.dumps({"knee": knee, "cell_rate": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
