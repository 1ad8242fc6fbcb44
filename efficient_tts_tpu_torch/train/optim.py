"""The reference's Adam + WarmupLR, step for step as the JAX package's optax chain.

Counterpart of `efficient_tts_tpu/train/optim.py:adam_warmup`, which
`utils/config.py:optimizer_from_dict` builds for the yaml (Adam lr 1e-3,
betas (0.9, 0.99), eps 1e-9, weight decay 1e-5, amsgrad, grad norm 1.0,
WarmupLR 4000). The chain, in optax's order:

  1. clip_by_global_norm: g * (max_norm / norm) only where norm >= max_norm
     (computed as (g / norm) * max_norm); torch's `clip_grad_norm_` adds
     1e-6 to the norm and is not used;
  2. add_decayed_weights: g + weight_decay * param (L2, before the moments);
  3. scale_by_amsgrad: mu and nu as Adam's, bias-corrected to mu_hat and
     nu_hat, then nu_max = max(nu_max, nu_hat) and mu_hat / (sqrt(nu_max) +
     eps). torch's `Adam(amsgrad=True)` keeps the max of the raw second
     moment, which differs from step 2, and is not used. Without amsgrad,
     scale_by_adam: mu_hat / (sqrt(nu_hat) + eps);
  4. scale_by_learning_rate: times -lr(count), the schedule reading the
     0-based count.

`HiFiGANAdam` is the vocoder's (`efficient_tts_tpu/train/optim.py:
hifigan_adam`): optax's scale_by_adam (b1 0.8, b2 0.99, eps 1e-8, eps_root
0) then scale_by_learning_rate with the per-epoch exponential decay, with
no clipping and no weight decay.

`RAdam` is `efficient_tts_tpu/train/optim.py:radam`: optional L2 decay,
optax's scale_by_radam (the bias-corrected first moment alone while the
variance's length ro is below 5, then the rectified step r * mu_hat /
(sqrt(nu_hat) + eps)), times -lr. `OPTIMIZER_REGISTRY` names the three.

`optimizer_from_dict` reads a training config's optimizer, scheduler and
grad_norm blocks as `efficient_tts_tpu/utils/config.py:optimizer_from_dict`
does: Adam with WarmupLR (or none) is `AdamWarmup`; RAdam is `RAdam`; any
other of `train/torch_optim.py`'s optimizers is a `Chain` of
`ClipByGlobalNorm(grad_norm)` (unless grad_norm is empty), the rule at its
lr without a scheduler, or at lr 1 followed by `ScaleBySchedule` with one
(torch multiplies every rule's final step by the group's lr, so this is
exact). An unknown name raises ValueError.

The bias corrections and the learning rate are host floats computed in
f32 as optax computes them. `update` is pure, as optax's is; the train
step adds the updates to the parameters in place. The states are dicts
(and lists) of host numbers and tensors, which `train/checkpoint.py` saves
and restores as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.train.schedule import exponential_decay_per_epoch, warmup_lr
from efficient_tts_tpu_torch.train.torch_optim import OPTIMIZER_FACTORIES, SCHEDULER_FACTORIES


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())


class ClipByGlobalNorm:
    """optax.clip_by_global_norm: g * (max_norm / norm) only where norm >= max_norm.
    `norm` is the gradients' global norm where the caller has it (over ranks,
    each holding slices of some leaves); without it the clip computes it."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: dict) -> dict:
        return {}

    def update(self, grads: dict, state: dict, params: dict, norm: torch.Tensor | None = None) -> tuple[dict, dict]:
        if norm is None:
            norm = global_norm(list(grads.values()))
        return {n: torch.where(norm < self.max_norm, g, (g / norm) * self.max_norm) for n, g in grads.items()}, state


class AdamWarmup:
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.99), eps: float = 1e-9, weight_decay: float = 1e-5,
                 amsgrad: bool = True, grad_clip_norm: float | None = 1.0, warmup_steps: int | None = 4000):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.amsgrad = amsgrad
        self.grad_clip_norm = grad_clip_norm
        self.schedule = warmup_lr(lr, warmup_steps) if warmup_steps else (lambda count: lr)

    def init(self, params: dict) -> dict:
        """{"count": 0, "mu", "nu"[, "nu_max"]}: zeros like each named parameter."""
        state = {"count": 0}
        for key in ("mu", "nu", "nu_max") if self.amsgrad else ("mu", "nu"):
            state[key] = {n: torch.zeros_like(p, memory_format=torch.contiguous_format) for n, p in params.items()}
        return state

    def update(self, grads: dict, state: dict, params: dict, norm: torch.Tensor | None = None) -> tuple[dict, dict]:
        """(updates, new state) for named gradients; nothing is changed in place.
        `norm` is their global norm, for the clip (`ClipByGlobalNorm`)."""
        names = list(grads)
        if self.grad_clip_norm is not None:
            grads, _ = ClipByGlobalNorm(self.grad_clip_norm).update(grads, {}, params, norm)
        g = [grads[n] for n in names]
        if self.weight_decay:
            g = [x + self.weight_decay * params[n] for x, n in zip(g, names)]
        count = state["count"] + 1
        f = np.float32
        bc1 = float(f(1.0) - _int_pow(self.b1, count))
        bc2 = float(f(1.0) - f(self.b2) ** f(count))
        step_size = -self.schedule(state["count"])
        new = {"count": count, "mu": {}, "nu": {}}
        if self.amsgrad:
            new["nu_max"] = {}
        updates = {}
        for n, x in zip(names, g):
            mu = (1 - self.b1) * x + self.b1 * state["mu"][n]
            nu = (1 - self.b2) * (x * x) + self.b2 * state["nu"][n]
            nu_hat = nu / bc2
            if self.amsgrad:
                nu_hat = new["nu_max"][n] = torch.maximum(state["nu_max"][n], nu_hat)
            updates[n] = step_size * ((mu / bc1) / (torch.sqrt(nu_hat) + self.eps))
            new["mu"][n], new["nu"][n] = mu, nu
        return updates, new


class HiFiGANAdam(AdamWarmup):
    """Adam (b1, b2) = (0.8, 0.99), eps 1e-8, at lr * lr_decay ** epoch, an
    epoch being `steps_per_epoch` updates (HiFi-GAN's config.json)."""

    def __init__(self, lr: float = 2e-4, betas=(0.8, 0.99), lr_decay: float = 0.999, steps_per_epoch: int = 1000):
        super().__init__(lr=lr, betas=betas, eps=1e-8, weight_decay=0.0, amsgrad=False, grad_clip_norm=None,
                         warmup_steps=None)
        self.schedule = exponential_decay_per_epoch(lr, lr_decay, steps_per_epoch)


def _int_pow(x: float, n: int) -> np.float32:
    """x ** n in f32 by binary exponentiation, as JAX raises a float to an
    int32 count (optax's bias corrections and RAdam's b2^t). The variance
    length ro cancels 2 / (1 - b2) - 1 against a near equal term, so an ulp
    of b2^t moves it visibly."""
    f = np.float32
    base, acc = f(x), f(1.0)
    while n:
        if n & 1:
            acc = f(acc * base)
        base, n = f(base * base), n >> 1
    return acc


class RAdam:
    """Rectified Adam in optax's order (`scale_by_radam`, threshold 5)."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, (self.b1, self.b2), self.eps, self.weight_decay = lr, betas, eps, weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                                   for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format) for n, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict, norm: torch.Tensor | None = None) -> tuple[dict, dict]:
        """`norm` is taken for the interface and unused: RAdam does not clip."""
        f = np.float32
        count = state["count"] + 1
        b2t = _int_pow(self.b2, count)
        ro_inf_host = 2.0 / (1.0 - self.b2) - 1.0  # a Python float in optax, rounded where it meets f32
        ro_inf = f(ro_inf_host)
        ro = ro_inf - f(2 * count) * b2t / (f(1.0) - b2t)
        bc1 = float(f(1.0) - _int_pow(self.b1, count))
        bc2 = float(f(1.0) - b2t)
        r = None
        if ro >= f(5.0):
            r = float(np.sqrt((ro - f(4.0)) * (ro - f(2.0)) * ro_inf
                              / (f((ro_inf_host - 4.0) * (ro_inf_host - 2.0)) * ro)))
        new = {"count": count, "mu": {}, "nu": {}}
        updates = {}
        for n, g in grads.items():
            if self.weight_decay:
                g = g + self.weight_decay * params[n]
            mu = new["mu"][n] = (1 - self.b1) * g + self.b1 * state["mu"][n]
            nu = new["nu"][n] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][n]
            mu_hat = mu / bc1
            u = mu_hat if r is None else r * mu_hat / (torch.sqrt(nu / bc2) + self.eps)
            updates[n] = -self.lr * u
        return updates, new


OPTIMIZER_REGISTRY = {"Adam": AdamWarmup, "RAdam": RAdam, "HiFiGANAdam": HiFiGANAdam}


class ScaleBySchedule:
    """optax.scale_by_schedule: updates times schedule(count), count from 0."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params: dict) -> dict:
        return {"count": 0}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        scale = self.schedule(state["count"])
        return {n: scale * g for n, g in grads.items()}, {"count": state["count"] + 1}


class Chain:
    """optax.chain: each transformation's updates feed the next; the state is
    the list of theirs."""

    def __init__(self, *parts):
        self.parts = parts

    def init(self, params: dict) -> list:
        return [p.init(params) for p in self.parts]

    def update(self, grads: dict, state: list, params: dict, norm: torch.Tensor | None = None) -> tuple[dict, list]:
        """`norm`, the global norm of `grads`, goes to a leading clip, the one
        part that sees `grads` as they were given."""
        new = []
        for i, (part, s) in enumerate(zip(self.parts, state, strict=True)):
            if i == 0 and isinstance(part, ClipByGlobalNorm):
                grads, s = part.update(grads, s, params, norm)
            else:
                grads, s = part.update(grads, s, params)
            new.append(s)
        return grads, new


def optimizer_from_dict(config: dict):
    """The optimizer of a training config's optimizer_type / optimizer_params,
    scheduler_type / scheduler_params and grad_norm (see the module's
    docstring for the branches)."""
    opt_type = config.get("optimizer_type", "Adam")
    opt = dict(config.get("optimizer_params", {}))
    sched_type = config.get("scheduler_type", "WarmupLR")
    sched = dict(config.get("scheduler_params", {}))
    grad_norm = config.get("grad_norm", 1.0)
    no_sched = sched_type in (None, "", "none")
    if opt_type == "Adam" and (no_sched or sched_type == "WarmupLR"):
        return AdamWarmup(
            lr=float(opt.get("lr", 1e-3)),
            betas=tuple(opt.get("betas", (0.9, 0.99))),
            eps=float(opt.get("eps", 1e-9)),
            weight_decay=float(opt.get("weight_decay", 0.0)),
            amsgrad=bool(opt.get("amsgrad", False)),
            grad_clip_norm=grad_norm,
            warmup_steps=sched.get("warmup_steps", 4000) if sched_type == "WarmupLR" else None,
        )
    if opt_type == "RAdam":
        return RAdam(lr=float(opt.get("lr", 1e-3)), betas=tuple(opt.get("betas", (0.9, 0.999))),
                     eps=float(opt.get("eps", 1e-8)), weight_decay=float(opt.get("weight_decay", 0.0)))
    if opt_type not in OPTIMIZER_FACTORIES:
        raise ValueError(f"unknown optimizer_type: {opt_type}")
    if "betas" in opt:
        opt["betas"] = tuple(opt["betas"])
    base_lr = float(opt.pop("lr", 1e-3))
    parts = [ClipByGlobalNorm(float(grad_norm))] if grad_norm else []
    if no_sched:
        return Chain(*parts, OPTIMIZER_FACTORIES[opt_type](lr=base_lr, **opt))
    if sched_type == "WarmupLR":
        schedule = warmup_lr(base_lr, sched.get("warmup_steps", 4000))
    elif sched_type in SCHEDULER_FACTORIES:
        schedule = SCHEDULER_FACTORIES[sched_type](base_lr, **sched)
    else:
        raise ValueError(f"unknown scheduler_type: {sched_type}")
    return Chain(*parts, OPTIMIZER_FACTORIES[opt_type](lr=1.0, **opt), ScaleBySchedule(schedule))
