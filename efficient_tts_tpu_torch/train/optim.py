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

The bias corrections and the learning rate are host floats computed in
f32 as optax computes them. `update` is pure, as optax's is; the train
step adds the updates to the parameters in place.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.train.schedule import exponential_decay_per_epoch, warmup_lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())


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

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        """(updates, new state) for named gradients; nothing is changed in place."""
        names = list(grads)
        g = [grads[n] for n in names]
        if self.grad_clip_norm is not None:
            norm = global_norm(g)
            g = [torch.where(norm < self.grad_clip_norm, x, (x / norm) * self.grad_clip_norm) for x in g]
        if self.weight_decay:
            g = [x + self.weight_decay * params[n] for x, n in zip(g, names)]
        count = state["count"] + 1
        f = np.float32
        bc1 = float(f(1.0) - f(self.b1) ** f(count))
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


def optimizer_from_dict(config: dict) -> AdamWarmup:
    """The optimizer of a training yaml's optimizer, scheduler and grad_norm
    blocks (`efficient_tts_tpu/utils/config.py:optimizer_from_dict`), for
    its Adam + WarmupLR branch, the one every config of the repo uses; any
    other optimizer or scheduler raises."""
    opt_type = config.get("optimizer_type", "Adam")
    sched_type = config.get("scheduler_type", "WarmupLR")
    if opt_type != "Adam" or sched_type not in ("WarmupLR", None, "", "none"):
        raise NotImplementedError(f"optimizer {opt_type!r} with scheduler {sched_type!r} is not ported; "
                                  "the port has Adam with WarmupLR or no scheduler")
    opt = dict(config.get("optimizer_params", {}))
    sched = dict(config.get("scheduler_params", {}))
    return AdamWarmup(
        lr=float(opt.get("lr", 1e-3)),
        betas=tuple(opt.get("betas", (0.9, 0.99))),
        eps=float(opt.get("eps", 1e-9)),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        amsgrad=bool(opt.get("amsgrad", False)),
        grad_clip_norm=config.get("grad_norm", 1.0),
        warmup_steps=sched.get("warmup_steps", 4000) if sched_type == "WarmupLR" else None,
    )
