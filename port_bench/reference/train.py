"""The recipe's optimizer and training step, plain.

Adam with amsgrad as optax chains it (the yaml's `optimizer_type: Adam`,
`amsgrad: true`, `grad_norm`, `scheduler_type: WarmupLR`): the gradients
clipped to the global norm (scaled by max_norm / norm where the norm is at
least max_norm), plus weight_decay times the parameter, then mu and nu,
bias-corrected, nu_max the running maximum of the corrected nu, and the
step -lr(count) * mu_hat / (sqrt(nu_max) + eps), lr(count) = lr *
warmup^0.5 * min((count + 1)^-0.5, (count + 1) * warmup^-1.5).
"""

from __future__ import annotations

import torch

from port_bench.reference.efts import TRAIN_LOSSES
from port_bench.reference.ops import Ops
from port_bench.weights import leaves


class Adam:
    def __init__(self, config: dict):
        opt = config["optimizer_params"]
        if config["optimizer_type"] != "Adam" or not opt.get("amsgrad") or config["scheduler_type"] != "WarmupLR":
            raise ValueError("the reference optimizer is Adam with amsgrad under WarmupLR")
        self.lr, (self.b1, self.b2) = float(opt["lr"]), opt["betas"]
        self.eps, self.wd = float(opt["eps"]), float(opt.get("weight_decay", 0.0))
        self.max_norm = float(config["grad_norm"])
        self.warmup = float(config["scheduler_params"]["warmup_steps"])

    def rate(self, count: int) -> float:
        step = count + 1.0
        return self.lr * self.warmup**0.5 * min(step**-0.5, step * self.warmup**-1.5)

    def init(self, params: list) -> dict:
        return {"count": 0, **{k: [torch.zeros_like(p) for p in params] for k in ("mu", "nu", "nu_max")}}

    @torch.no_grad()
    def step(self, params: list, grads: list, state: dict) -> None:
        """Update `params` and `state` in place."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        count = state["count"] + 1
        bc1, bc2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        lr = self.rate(state["count"])
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g * scale + self.wd * p
            state["mu"][i] = (1 - self.b1) * g + self.b1 * state["mu"][i]
            state["nu"][i] = (1 - self.b2) * g * g + self.b2 * state["nu"][i]
            state["nu_max"][i] = torch.maximum(state["nu_max"][i], state["nu"][i] / bc2)
            p.sub_(lr * (state["mu"][i] / bc1) / (torch.sqrt(state["nu_max"][i]) + self.eps))
        state["count"] = count


def train_steps(tree: dict, config: dict, batches: list, keys: list, ops: Ops) -> dict:
    """Run len(batches) steps from the weights `tree` (copied, not changed)
    on `batches`, step i's dropout from the CPU generator `keys[i]` (None
    without dropout). Returns {"paths", "loss" [per step], "first_grad"
    (each leaf's norm of the first gradient as the optimizer takes it,
    mu / (1 - b1) after one step), "raw_grad" (each leaf's norm of the first
    unclipped gradient), "change" (each leaf's norm of its change over the
    steps)}."""
    named = list(leaves(tree))
    paths = [p for p, _ in named]
    start = [t.detach().clone() for _, t in named]
    params = [t.detach().clone().requires_grad_(True) for _, t in named]
    rebuilt = _rebuild(tree, params)
    loss_fn = TRAIN_LOSSES[config["model_name"]]
    opt = Adam(config)
    state = opt.init(params)
    out = {"paths": paths, "loss": []}
    for i, (batch, key) in enumerate(zip(batches, keys)):
        with ops.precision(batch["text"].device):
            mel_loss, dur_loss = loss_fn(rebuilt, config["model_params"], batch, ops, key)
            loss = mel_loss + dur_loss
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["raw_grad"] = [float(torch.linalg.vector_norm(g)) for g in grads]
        opt.step(params, grads, state)
        if i == 0:
            out["first_grad"] = [float(torch.linalg.vector_norm(m)) / (1 - opt.b1) for m in state["mu"]]
        del grads, loss, mel_loss, dur_loss
    out["change"] = [float(torch.linalg.vector_norm(p.detach() - s)) for p, s in zip(params, start)]
    return out


def _rebuild(tree, params):
    """`tree` with its leaves, in order, replaced by `params`."""
    it = iter(params)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)
