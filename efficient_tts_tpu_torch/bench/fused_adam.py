"""The train step's optimizer on the card: the fused kernels against the per-tensor path.

    python -m efficient_tts_tpu_torch.bench.fused_adam

Over the parameters of each recipe's acoustic model built on the card
(`configs/`; EFTS-Transformer: 186 leaves, 42.6M parameters; EFTS-CNN:
61, 20.6M), N(0, 0.1), with gradients of global norm about 3 (the clip
engaged), seeded, under the recipe's `AdamWarmup` (weight decay, amsgrad,
grad norm 1):

First a check, CHECK_STEPS steps from one state on the same gradients:
`train/state.py:apply_updates` (the fused kernels of `ops/fused_adam.py`)
against `AdamWarmup.update` plus one add_ a leaf given the fused norm. The
parameters, mu, nu and nu_max must be bit-equal after each step, and the
fused norm within NORM_TOL of `train/optim.py:global_norm`; the kernels'
launches and the leaves they copied are counted.

Then one optimizer step (global norm, clip, weight decay, Adam with
amsgrad) in three versions, each timed with CUDA events (median of 20
steps; the host's Python between the launches included):

  fused    `train/optim.py:grad_norm` then `apply_updates` (the train
           step's path);
  plain    `train/optim.py:global_norm`, `AdamWarmup.update` and one add_ a
           leaf (the per-tensor path);
  library  torch._foreach_* ops in optax's order: a yardstick the port never
           calls.

Beside each: its kernel launches a step and their summed device time (from
the profiler's trace of one step), and the bytes bound, 40 bytes a
parameter (the norm reads g; the update reads g, p, mu, nu, nu_max and
writes p, mu, nu, nu_max) at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import torch

from efficient_tts_tpu_torch.bench import card_line, require_card, time_ms
from efficient_tts_tpu_torch.ops import fused_adam
from efficient_tts_tpu_torch.train.optim import AdamWarmup, global_norm, grad_norm
from efficient_tts_tpu_torch.train.state import apply_updates, create_state, named_params

CONFIGS = {"transformer": "lj_efts_transformer_phnseq.yaml", "cnn": "lj_efts_cnn_char.yaml"}
BYTES_PER_PARAM = 40
HBM_BYTES_PER_S = 3.35e12
CHECK_STEPS = 3
NORM_TOL = 2e-6


def recipe_model(model: str, device, seed: int = 0) -> torch.nn.Module:
    """The recipe's acoustic model for training (`configs/`), built on
    `device` with every parameter trainable and N(0, 0.1) from `seed` (its
    buffers left unset: the optimizer reads none)."""
    from efficient_tts_tpu_torch.models import model_class_for
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict

    cfg = model_config_from_dict(load_config(str(Path(__file__).resolve().parents[1] / "configs" / CONFIGS[model])))
    with torch.device("meta"):
        net = model_class_for(cfg, training=True)(cfg, training_modules=True)
    net = net.to_empty(device=device).requires_grad_(True)  # every parameter trainable, as `compat` makes them
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, 0.1, generator=g)
    return net


def recipe_tx() -> AdamWarmup:
    return AdamWarmup(weight_decay=1e-5, amsgrad=True, grad_clip_norm=1.0, warmup_steps=4000)


def gradients(params: dict, norm: float, seed: int) -> dict:
    """Seeded gradients like `params` of global norm about `norm`."""
    first = next(iter(params.values()))
    g = torch.Generator(device=first.device).manual_seed(seed)
    grads = {n: torch.randn(p.shape, generator=g, device=p.device) for n, p in params.items()}
    scale = norm / float(global_norm(list(grads.values())))
    return {n: x * scale for n, x in grads.items()}


def check_model(model: str, device, steps: int = CHECK_STEPS) -> dict:
    """The fused path against the per-tensor path from one state (see the
    module's docstring): {"bit_equal", "unequal" (the first 5 (step, tensor,
    leaf) that differ), "norm_rel_err" (the largest), "launches",
    "copied_leaves"}."""
    tx = recipe_tx()
    state = create_state(recipe_model(model, device), tx)
    params = named_params(state["params"])
    ref = {n: p.detach().clone() for n, p in params.items()}
    ref_opt = tx.init(ref)
    unequal, norm_err = [], 0.0
    fused_adam.reset_launches()
    for step in range(steps):
        grads = gradients(params, 3.0 + step, seed=1 + step)
        norm, plain = grad_norm(grads), global_norm(list(grads.values()))
        norm_err = max(norm_err, abs(float(norm) - float(plain)) / float(plain))
        apply_updates(state, grads, tx, norm)
        updates, ref_opt = tx.update(grads, ref_opt, ref, norm=norm)
        for n, u in updates.items():
            ref[n].add_(u)
        got = {"param": params, **{k: state["opt_state"][k] for k in ("mu", "nu", "nu_max")}}
        want = {"param": ref, **{k: ref_opt[k] for k in ("mu", "nu", "nu_max")}}
        unequal += [(step, k, n) for k in want for n in want[k] if not torch.equal(got[k][n].detach(), want[k][n])]
    torch.cuda.synchronize(device)
    return {"steps": steps, "bit_equal": not unequal, "unequal": unequal[:5], "norm_rel_err": norm_err,
            "launches": dict(fused_adam.launches), "copied_leaves": dict(fused_adam.copied_leaves)}


def library_step(tx: AdamWarmup, opt: dict, params: list, grads: list) -> None:
    """optax's chain as torch._foreach_* ops, in place."""
    count = opt["count"] = opt["count"] + 1
    bc1, bc2, step_size = 1 - tx.b1**count, 1 - tx.b2**count, -tx.schedule(count - 1)
    mu, nu, nu_max = (list(opt[k].values()) for k in ("mu", "nu", "nu_max"))
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    g = torch._foreach_mul(grads, torch.where(norm < tx.grad_clip_norm, 1.0, tx.grad_clip_norm / norm))
    torch._foreach_add_(g, params, alpha=tx.weight_decay)
    torch._foreach_mul_(mu, tx.b1)
    torch._foreach_add_(mu, g, alpha=1 - tx.b1)
    torch._foreach_mul_(g, g)
    torch._foreach_mul_(nu, tx.b2)
    torch._foreach_add_(nu, g, alpha=1 - tx.b2)
    torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
    denom = torch._foreach_sqrt(nu_max)
    torch._foreach_add_(denom, tx.eps)
    u = torch._foreach_div(mu, bc1)
    torch._foreach_div_(u, denom)
    torch._foreach_add_(params, u, alpha=step_size)


def device_kernels(fn) -> tuple[int, float]:
    """(kernels, their summed ms) that one call of `fn` runs on the device,
    from the profiler's trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return len(kernels), sum(float(e["dur"]) for e in kernels) * 1e-3


def bench_model(model: str, device) -> dict:
    check = check_model(model, device)
    print(f"{model:11s} check   {check}")
    tx = recipe_tx()
    state = create_state(recipe_model(model, device), tx)
    named = named_params(state["params"])
    names, params = list(named), list(named.values())
    grads = gradients(named, 3.0, seed=1)
    plain = {"params": {n: p.detach().clone() for n, p in named.items()}}
    plain["opt"] = tx.init(plain["params"])
    lib = {"params": [p.detach().clone() for p in params]}
    lib["opt"] = tx.init(dict(zip(names, lib["params"])))

    def fused_step():
        apply_updates(state, grads, tx, grad_norm(grads))

    def plain_step():
        norm = global_norm(list(grads.values()))
        updates, plain["opt"] = tx.update(grads, plain["opt"], plain["params"], norm=norm)
        for n, u in updates.items():
            plain["params"][n].add_(u)

    def library():
        library_step(tx, lib["opt"], lib["params"], list(grads.values()))

    n_params = sum(p.numel() for p in params)
    bound_ms = BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    out = {"leaves": len(names), "params": n_params, "bound_ms": bound_ms, "check": check}
    for name, fn in (("fused", fused_step), ("plain", plain_step), ("library", library)):
        t = time_ms(fn)
        launches, kernel_ms = device_kernels(fn)
        out[name] = {"ms": t, "launches": launches, "kernel_ms": kernel_ms, "bound_share": bound_ms / kernel_ms}
        print(f"{model:11s} {name:7s} {t['median']:8.3f} ms a call (p25 {t['p25']:.3f}, p75 {t['p75']:.3f}), "
              f"kernels {kernel_ms:8.3f} ms, {launches:5d} launches, {100 * bound_ms / kernel_ms:5.1f}% of the "
              f"bytes bound ({bound_ms:.3f} ms)")
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = require_card()
    card = card_line()
    print(card)
    return {"card": card, **{m: bench_model(m, dev) for m in CONFIGS}}


if __name__ == "__main__":
    main()
