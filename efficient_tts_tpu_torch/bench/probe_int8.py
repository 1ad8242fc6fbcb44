"""Matmul rate probe on the card, bf16 against int8: port of
`scripts/probe_int8_pallas.py`.

    python -m efficient_tts_tpu_torch.bench.probe_int8

[M, 128] x [128, 128] applied 8 times per row (M = 2^20) through K5's
kernel `ops/probe_matmul.py:probe_matmul`, in bf16 (f32 accumulation, bf16
between repeats) and int8 (int32 accumulation, the int8 wrap between
repeats), and beside it the library's chains: 8 x torch.matmul in bf16, and
8 x torch._int_mm in int8, each product cast to int8. Inputs as the
script's, from numpy's generator seeded 0: bf16 x N(0, 1) and w 0.05 N(0,
1); int8 integers in [-3, 3). Times are CUDA-event medians; TF/s counts
2*M*128*128*8 operations. Unlike the script, a failure raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from efficient_tts_tpu_torch.bench import card_line, require_card, time_ms
from efficient_tts_tpu_torch.ops import probe_matmul as pm

M, REPEAT = 1 << 20, 8


def make_inputs(m: int, device) -> dict:
    """{"bf16": (x, w), "int8": (x, w)} drawn in the script's order."""
    rng = np.random.default_rng(0)
    out = {}
    for name in ("bf16", "int8"):
        if name == "int8":
            x, w = rng.integers(-3, 3, (m, pm.K)), rng.integers(-3, 3, (pm.K, pm.K))
            dt = torch.int8
        else:
            x, w = rng.standard_normal((m, pm.K)), 0.05 * rng.standard_normal((pm.K, pm.K))
            dt = torch.bfloat16
        out[name] = tuple(torch.from_numpy(a).to(device).to(dt).contiguous() for a in (x, w))
    return out


def library_chain(x, w, repeat: int = REPEAT):
    """The product chain through the library: torch.matmul in bf16, or
    torch._int_mm (int32) cast to int8 after each product."""
    y = x
    for _ in range(repeat):
        y = torch._int_mm(y, w).to(torch.int8) if x.dtype == torch.int8 else torch.matmul(y, w)
    return y


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = require_card()
    card = card_line()
    ops = 2.0 * M * pm.K * pm.K * REPEAT
    print(f"{card}: [{M}, {pm.K}] x [{pm.K}, {pm.K}] x {REPEAT}")
    times, outs = {}, {}
    for name, (x, w) in make_inputs(M, dev).items():
        for impl, fn in (("kernel", lambda: pm.probe_matmul(x, w, REPEAT)), ("torch", lambda: library_chain(x, w))):
            outs[impl, name] = fn()
            t = times[f"{impl} {name}"] = time_ms(fn)
            print(f"{impl:6s} {name}: {t['median']:7.3f} ms  {ops / (t['median'] * 1e9):6.1f} TF/s")
    ratio = times["kernel bf16"]["median"] / times["kernel int8"]["median"]
    print(f"kernel int8/bf16 rate ratio: {ratio:.3f}")
    # the int8 chains are exact integer arithmetic with the same wraps
    if not torch.equal(outs["kernel", "int8"], outs["torch", "int8"]):
        raise AssertionError("the int8 kernel and the torch._int_mm chain disagree")
    return {"card": card, "m": M, "times": times, "int8_over_bf16_rate": ratio}


if __name__ == "__main__":
    main()
