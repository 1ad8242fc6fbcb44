"""Learning-rate schedules (counterpart of `efficient_tts_tpu/train/schedule.py`).

`warmup_lr` is the reference's WarmupLR:
    lr(step) = base_lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)
peaking at `base_lr` when step == warmup_steps. The optimizer hands the
0-based count of updates already made, hence step = count + 1. Computed in
f32, as the JAX schedule is.
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
