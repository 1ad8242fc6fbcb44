"""torch.optim's update rules and lr schedules behind the port's optimizer interface.

Counterpart of `efficient_tts_tpu/train/torch_optim.py`. The reference lets
a config name any torch.optim optimizer and any lr scheduler; the JAX
package rebuilds each as an optax transformation that follows torch's
documented algorithm step for step, and the port rebuilds those. Each rule
is a class with the port's optimizer interface (`train/optim.py`):
`init(params) -> state` and `update(grads, state, params) -> (updates, new
state)` on dicts of named tensors, pure as `AdamWarmup.update` is; the
train step adds the updates to the parameters. `torch.optim` itself is not
wrapped: its state lives in the optimizer object, not in the train state.

Semantics, as the JAX package's:
  * `weight_decay` is L2 (g + wd * p before the moments) everywhere but
    AdamW, which decays the parameter: the update gets - lr * wd * p;
  * SGD's first momentum step sets buf = g, not (1 - dampening) * g;
  * Adam and RMSprop add eps outside the square root;
  * the host-side scalars (counts, bias corrections, NAdam's mu product,
    learning rates) are f32 host floats computed as the JAX package
    computes them, in f32.
Schedules are functions count -> lr of the 0-based count of updates made,
torch's `last_epoch` when the reference steps the scheduler once an update;
`train/optim.py:optimizer_from_dict` scales a rule built at lr 1 by them.
LBFGS and ReduceLROnPlateau are left out, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_f = np.float32


def _zeros(params: dict) -> dict:
    return {n: torch.zeros_like(p, memory_format=torch.contiguous_format) for n, p in params.items()}


def _l2(grads: dict, params: dict, weight_decay: float) -> dict:
    if not weight_decay:
        return dict(grads)
    return {n: g + weight_decay * params[n] for n, g in grads.items()}


def _sq_avg(decay: float, old: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """decay * old + (1 - decay) * x * x, rounded in the JAX package's order."""
    return decay * old + (1 - decay) * x * x


class SGD:
    def __init__(self, lr: float = 1e-3, momentum: float = 0.0, dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        self.lr, self.momentum, self.dampening = lr, momentum, dampening
        self.weight_decay, self.nesterov = weight_decay, nesterov

    def init(self, params: dict) -> dict:
        return {"count": 0, "buf": _zeros(params) if self.momentum else {}}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        buf = state["buf"]
        if self.momentum:
            if state["count"] == 0:
                buf = g
            else:
                buf = {n: self.momentum * buf[n] + (1.0 - self.dampening) * x for n, x in g.items()}
            g = {n: x + self.momentum * buf[n] for n, x in g.items()} if self.nesterov else buf
        return {n: -self.lr * x for n, x in g.items()}, {"count": state["count"] + 1, "buf": buf}


class Adam:
    """torch.optim.Adam, and AdamW with `decoupled=True`:
    p -= lr * m_hat / (sqrt(v_hat) + eps), amsgrad on the raw second moment."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False, decoupled: bool = False):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.weight_decay, self.amsgrad, self.decoupled = weight_decay, amsgrad, decoupled

    def init(self, params: dict) -> dict:
        state = {"count": 0, "m": _zeros(params), "v": _zeros(params)}
        if self.amsgrad:
            state["vmax"] = _zeros(params)
        return state

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = grads if self.decoupled else _l2(grads, params, self.weight_decay)
        count = state["count"] + 1
        t = _f(count)
        bc1, bc2 = float(_f(1.0) - _f(self.b1) ** t), float(_f(1.0) - _f(self.b2) ** t)
        new = {"count": count, "m": {}, "v": {}}
        if self.amsgrad:
            new["vmax"] = {}
        updates = {}
        for n, x in g.items():
            m = new["m"][n] = self.b1 * state["m"][n] + (1 - self.b1) * x
            v = new["v"][n] = _sq_avg(self.b2, state["v"][n], x)
            if self.amsgrad:
                v = new["vmax"][n] = torch.maximum(state["vmax"][n], v)
            u = -self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay and self.decoupled:
                u = u - self.lr * self.weight_decay * params[n]
            updates[n] = u
        return updates, new


class AdamW(Adam):
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        super().__init__(lr, betas, eps, weight_decay, amsgrad, decoupled=True)


class Adamax:
    """u = max(b2 * u, |g| + eps); p -= lr / (1 - b1^t) * m / u."""

    def __init__(self, lr: float = 2e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, (self.b1, self.b2), self.eps, self.weight_decay = lr, betas, eps, weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0, "m": _zeros(params), "u": _zeros(params)}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        count = state["count"] + 1
        clr = float(_f(self.lr) / (_f(1.0) - _f(self.b1) ** _f(count)))
        new = {"count": count, "m": {}, "u": {}}
        updates = {}
        for n, x in g.items():
            m = new["m"][n] = self.b1 * state["m"][n] + (1 - self.b1) * x
            u = new["u"][n] = torch.maximum(self.b2 * state["u"][n], torch.abs(x) + self.eps)
            updates[n] = -clr * m / u
        return updates, new


class Adagrad:
    """lr_t = lr / (1 + (t - 1) * lr_decay); p -= lr_t * g / (sqrt(sum g^2) + eps)."""

    def __init__(self, lr: float = 1e-2, lr_decay: float = 0.0, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.0, eps: float = 1e-10):
        self.lr, self.lr_decay, self.weight_decay = lr, lr_decay, weight_decay
        self.initial_accumulator_value, self.eps = initial_accumulator_value, eps

    def init(self, params: dict) -> dict:
        return {"count": 0, "sum": {n: torch.full_like(p, self.initial_accumulator_value,
                                                       memory_format=torch.contiguous_format)
                                    for n, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        count = state["count"] + 1
        clr = float(_f(self.lr) / (_f(1.0) + (_f(count) - _f(1.0)) * _f(self.lr_decay)))
        new = {"count": count, "sum": {}}
        updates = {}
        for n, x in g.items():
            acc = new["sum"][n] = state["sum"][n] + x * x
            updates[n] = -clr * x / (torch.sqrt(acc) + self.eps)
        return updates, new


class Adadelta:
    def __init__(self, lr: float = 1.0, rho: float = 0.9, eps: float = 1e-6, weight_decay: float = 0.0):
        self.lr, self.rho, self.eps, self.weight_decay = lr, rho, eps, weight_decay

    def init(self, params: dict) -> dict:
        return {"sq_avg": _zeros(params), "acc_delta": _zeros(params)}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        new = {"sq_avg": {}, "acc_delta": {}}
        updates = {}
        for n, x in g.items():
            sq = new["sq_avg"][n] = _sq_avg(self.rho, state["sq_avg"][n], x)
            delta = x * torch.sqrt(state["acc_delta"][n] + self.eps) / torch.sqrt(sq + self.eps)
            new["acc_delta"][n] = _sq_avg(self.rho, state["acc_delta"][n], delta)
            updates[n] = -self.lr * delta
        return updates, new


class RMSprop:
    """eps outside the square root (optax's is inside); `centered`
    subtracts the squared running mean; `momentum` keeps a buffer."""

    def __init__(self, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.0, centered: bool = False):
        self.lr, self.alpha, self.eps, self.weight_decay = lr, alpha, eps, weight_decay
        self.momentum, self.centered = momentum, centered

    def init(self, params: dict) -> dict:
        return {"count": 0, "sq": _zeros(params), "avg": _zeros(params) if self.centered else {},
                "buf": _zeros(params) if self.momentum else {}}

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        new = {"count": state["count"] + 1, "sq": {}, "avg": {}, "buf": {}}
        updates = {}
        for n, x in g.items():
            sq = new["sq"][n] = _sq_avg(self.alpha, state["sq"][n], x)
            if self.centered:
                avg = new["avg"][n] = self.alpha * state["avg"][n] + (1 - self.alpha) * x
                denom = torch.sqrt(sq - avg * avg) + self.eps
            else:
                denom = torch.sqrt(sq) + self.eps
            scaled = x / denom
            if self.momentum:
                scaled = new["buf"][n] = self.momentum * state["buf"][n] + scaled
            updates[n] = -self.lr * scaled
        return updates, new


class NAdam:
    """torch.optim.NAdam with its momentum schedule mu_t = b1 (1 - 0.5 *
    0.96^(t * momentum_decay)) and the running product of the mu_t."""

    def __init__(self, lr: float = 2e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum_decay: float = 4e-3):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.weight_decay, self.momentum_decay = weight_decay, momentum_decay

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu_product": 1.0, "m": _zeros(params), "v": _zeros(params)}

    def _mu(self, t) -> np.float32:
        return _f(self.b1) * (_f(1.0) - _f(0.5) * _f(0.96) ** (t * _f(self.momentum_decay)))

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        g = _l2(grads, params, self.weight_decay)
        count = state["count"] + 1
        t = _f(count)
        mu_t, mu_next = self._mu(t), self._mu(t + _f(1.0))
        mu_product = _f(state["mu_product"]) * mu_t
        mu_product_next = mu_product * mu_next
        bc2 = float(_f(1.0) - _f(self.b2) ** t)
        c_g = float((_f(1.0) - mu_t) / (_f(1.0) - mu_product))
        c_m = float(mu_next / (_f(1.0) - mu_product_next))
        new = {"count": count, "mu_product": float(mu_product), "m": {}, "v": {}}
        updates = {}
        for n, x in g.items():
            m = new["m"][n] = self.b1 * state["m"][n] + (1 - self.b1) * x
            v = new["v"][n] = _sq_avg(self.b2, state["v"][n], x)
            updates[n] = -self.lr * (c_g * x + c_m * m) / (torch.sqrt(v / bc2) + self.eps)
        return updates, new


# ---------------------------------------------------------------------------
# torch.optim.lr_scheduler's formulas, count -> lr, in f32


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1):
    def schedule(count: int) -> float:
        return float(_f(base_lr) * _f(gamma) ** np.floor_divide(_f(count), _f(step_size)))

    return schedule


def multi_step_lr(base_lr: float, milestones, gamma: float = 0.1):
    ms = np.asarray(sorted(milestones), np.float32)

    def schedule(count: int) -> float:
        return float(_f(base_lr) * _f(gamma) ** _f(np.sum(ms <= _f(count))))

    return schedule


def exponential_lr(base_lr: float, gamma: float):
    def schedule(count: int) -> float:
        return float(_f(base_lr) * _f(gamma) ** _f(count))

    return schedule


def _cosine(base_lr, eta_min, t_cur, t_i):
    return float(_f(eta_min) + _f(base_lr - eta_min) * (_f(1.0) + np.cos(_f(math.pi) * t_cur / t_i)) / _f(2.0))


def cosine_annealing_lr(base_lr: float, T_max: int, eta_min: float = 0.0):
    def schedule(count: int) -> float:
        return _cosine(base_lr, eta_min, _f(count), _f(T_max))

    return schedule


def cosine_annealing_warm_restarts(base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
    def schedule(count: int) -> float:
        e = _f(count)
        if T_mult == 1:
            return _cosine(base_lr, eta_min, np.mod(e, _f(T_0)), _f(T_0))
        # the cycle n with sum_{i<n} T_0 * T_mult^i <= e, in closed form
        n = np.floor(np.log(e / _f(T_0) * _f(T_mult - 1) + _f(1.0)) / _f(math.log(T_mult)))
        start = _f(T_0) * (_f(T_mult) ** n - _f(1.0)) / _f(T_mult - 1)
        return _cosine(base_lr, eta_min, e - start, _f(T_0) * _f(T_mult) ** n)

    return schedule


def linear_lr(base_lr: float, start_factor: float = 1.0 / 3, end_factor: float = 1.0, total_iters: int = 5):
    def schedule(count: int) -> float:
        e = np.minimum(_f(count), _f(total_iters))
        return float(_f(base_lr) * (_f(start_factor) + _f(end_factor - start_factor) * e / _f(total_iters)))

    return schedule


def constant_lr(base_lr: float, factor: float = 1.0 / 3, total_iters: int = 5):
    def schedule(count: int) -> float:
        return float(_f(base_lr) * (_f(factor) if count < total_iters else _f(1.0)))

    return schedule


def polynomial_lr(base_lr: float, total_iters: int = 5, power: float = 1.0):
    def schedule(count: int) -> float:
        e = np.minimum(_f(count), _f(total_iters))
        return float(_f(base_lr) * (_f(1.0) - e / _f(total_iters)) ** _f(power))

    return schedule


OPTIMIZER_FACTORIES = {
    "SGD": SGD,
    "Adam": Adam,
    "AdamW": AdamW,
    "Adamax": Adamax,
    "Adagrad": Adagrad,
    "Adadelta": Adadelta,
    "RMSprop": RMSprop,
    "NAdam": NAdam,
}

SCHEDULER_FACTORIES = {
    "StepLR": step_lr,
    "MultiStepLR": multi_step_lr,
    "ExponentialLR": exponential_lr,
    "CosineAnnealingLR": cosine_annealing_lr,
    "CosineAnnealingWarmRestarts": cosine_annealing_warm_restarts,
    "LinearLR": linear_lr,
    "ConstantLR": constant_lr,
    "PolynomialLR": polynomial_lr,
}
