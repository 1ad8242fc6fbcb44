"""Learning-rate schedules (counterpart of `efficient_tts_tpu/train/schedule.py`).

`warmup_lr` is the reference's WarmupLR:
    lr(step) = base_lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)
peaking at `base_lr` when step == warmup_steps. The optimizer hands the
0-based count of updates already made, hence step = count + 1.
`exponential_decay_per_epoch` is HiFi-GAN's ExponentialLR stepped once an
epoch: base_lr * gamma ** (count // steps_per_epoch), the count before the
update. Both are computed in f32, as the JAX schedules are.
"""

from __future__ import annotations

import numpy as np


def warmup_lr(base_lr: float, warmup_steps: int = 25000):
    def schedule(count: int) -> float:
        f = np.float32
        step = f(count) + f(1.0)
        w = f(warmup_steps)
        return float(f(base_lr) * w ** f(0.5) * np.minimum(step ** f(-0.5), step * w ** f(-1.5)))

    return schedule


def exponential_decay_per_epoch(base_lr: float, gamma: float, steps_per_epoch: int):
    def schedule(count: int) -> float:
        f = np.float32
        epoch = np.floor_divide(f(count), f(steps_per_epoch))
        return float(f(base_lr) * np.power(f(gamma), epoch))

    return schedule
