"""The W8A8 MRF stage against the bf16 one on the card: port of
`scripts/bench_mrf_fused.py`.

    python -m efficient_tts_tpu_torch.bench.mrf_fused [--batch 16] [--m 65536] [--ch 32]

One V1 MRF stage (kernels 3/7/11, dilations 1/3/5) at the script's stage-3
serving shape: ch=32, B=16 and M=65536 packed blocks of 128 lanes, that is
[B, T, ch] bf16 with T = M*128/ch = 262144 positions. The input and weights
come from numpy's seeded generator at the script's scales (input 0.5 N(0,
1), weights 0.15 N(0, 1), biases 0.1 N(0, 1)). Four versions, each timed
with CUDA events:

  cudnn bf16          the stage in PyTorch: 18 bf16 cuDNN convolutions with
                      the leaky, residual adds and average between them (the
                      counterpart of the script's "xla-packed bf16");
  kernel bf16         K1's kernel, `ops/mrf.py:mrf_stage`;
  kernel int8         K2's kernel, `ops/mrf_int8.py:mrf_stage_int8`, with
                      dynamic activation scales (its weights' TMA
                      descriptors made once, outside the timed calls);
  kernel int8-static  the same with `calibrate_act_scales` of the input;

then the bf16 kernel's parity with the cuDNN stage and the int8 kernels'
deviation from it (max |difference| over the whole output). The script's
`--t_tile` has no counterpart here: the port's kernels have no sequence
tiles, and the dynamic scale covers all of [0, T). Unlike the script, a
version that fails raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.bench import card_line, require_card, time_ms
from efficient_tts_tpu_torch.nn.layers import leaky_relu
from efficient_tts_tpu_torch.ops import mrf, mrf_int8
from efficient_tts_tpu_torch.utils.precision import full_f32

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
LANES = 128


def make_stage(batch: int, m: int, ch: int, device) -> dict:
    """The script's stage on `device`: x [batch, m*128/ch, ch] bf16, the f32
    and bf16 weights per conv [k, C_out, C_in], f32 biases [18, ch], the int8
    weights with their scales, and the static activation scales of x."""
    if LANES % ch:
        raise ValueError(f"ch={ch} must divide {LANES}")
    rng = np.random.default_rng(1)
    order = mrf.conv_order(KS, DILS)
    # [k, C_in, C_out] as in the JAX tree, then the kernels' [k, C_out, C_in]
    w32 = [torch.from_numpy(np.ascontiguousarray((0.15 * rng.standard_normal((k, ch, ch))).transpose(0, 2, 1),
                                                 np.float32)).to(device) for k, _ in order]
    biases = torch.from_numpy((0.1 * rng.standard_normal((len(order), ch))).astype(np.float32)).to(device)
    x = 0.5 * np.random.default_rng(0).standard_normal((batch, m, LANES))
    x = torch.from_numpy(x).to(device).to(torch.bfloat16).reshape(batch, m * LANES // ch, ch)
    wq, scales = mrf_int8.quantize_weights(w32)
    with full_f32():
        act = mrf_int8.calibrate_act_scales(x, w32, biases, KS, DILS)
    return {"x": x, "w32": w32, "w_bf16": [w.to(torch.bfloat16) for w in w32], "biases": biases,
            "wq": wq, "scales": scales, "act_scales": act, "order": order}


def cudnn_stage(x_ncw, w_ncw, b_bf16, order):
    """The stage on [B, C, T] bf16 through F.conv1d (cuDNN on the card)."""
    def conv(a, i, d):
        k = order[i][0]
        return F.conv1d(leaky_relu(a, mrf.LRELU_SLOPE), w_ncw[i], b_bf16[i], padding=(k - 1) // 2 * d, dilation=d)

    return mrf.stage_chain(x_ncw, conv, DILS)


def versions(st: dict) -> dict:
    """{name: callable} of the four versions; each returns [B, T, C] bf16."""
    x, biases, wq, scales = st["x"], st["biases"], st["wq"], st["scales"]
    x_ncw = x.transpose(1, 2).contiguous()
    w_ncw = [w.permute(1, 2, 0).contiguous() for w in st["w_bf16"]]
    b_bf16 = biases.to(torch.bfloat16)
    w_kernel = mrf.kernel_weights(st["w_bf16"])  # the TMA descriptors, made once as the generator does
    wq_kernel = mrf_int8.kernel_weights(wq)  # and those of the int8 weights
    return {
        "cudnn bf16": lambda: cudnn_stage(x_ncw, w_ncw, b_bf16, st["order"]).transpose(1, 2),
        "kernel bf16": lambda: mrf.mrf_stage(x, w_kernel, biases, KS, DILS),
        "kernel int8": lambda: mrf_int8.mrf_stage_int8(x, wq_kernel, scales, biases, KS, DILS),
        "kernel int8-static": lambda: mrf_int8.mrf_stage_int8(x, wq_kernel, scales, biases, KS, DILS,
                                                              st["act_scales"]),
    }


def deviations(outs: dict) -> dict:
    """Max |version - cudnn bf16| over the whole output, for each kernel."""
    ref = outs["cudnn bf16"].float()
    return {name: float((out.float() - ref).abs().max()) for name, out in outs.items() if name != "cudnn bf16"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--m", type=int, default=65536, help="packed blocks of 128 lanes: T = m*128/ch")
    ap.add_argument("--ch", type=int, default=32)
    args = ap.parse_args(argv)
    dev = require_card()
    card = card_line()
    st = make_stage(args.batch, args.m, args.ch, dev)
    print(f"{card}: shape {list(st['x'].shape)} (packed [{args.batch}, {args.m}, {LANES}])")
    outs, times = {}, {}
    for name, fn in versions(st).items():
        outs[name] = fn()
        times[name] = time_ms(fn)
        print(f"{name:18s} {times[name]['median']:8.3f} ms")
    dev_ = deviations(outs)
    print("bf16 parity vs cudnn:", dev_["kernel bf16"])
    print("int8 dev vs cudnn:", dev_["kernel int8"])
    print("int8-static dev vs cudnn:", dev_["kernel int8-static"])
    return {"card": card, "shape": list(st["x"].shape), "times": times, "max_abs_dev_vs_cudnn": dev_}


if __name__ == "__main__":
    main()
