"""The DurationModel's train step (counterpart of `efficient_tts_tpu/train/duration_train_step.py`).

`init_duration_state(seed, cfg, tx)` builds the model from the seeded
numpy init (`init.py`) and the train state {"params": model,
"opt_state", "step": 0, "rng": seed}. `make_duration_train_step(cfg, tx)`
returns `train_step(state, batch) -> (state, {"loss"})` over
`data/collate.py:collate_duration_model` batches (ppg [B, T, idim],
lengths, durations, spkids), in JAX's order: split the state's key into
the next key and this step's, the loss and its gradients (dropout from
this step's key), the optimizer update, step + 1. The key is a host int:
a CPU generator seeded by it draws the two new ones, so the dropout stream
is a function of the initial seed and the step count, and a checkpoint
carries it. The speaker ids are used only when the config has a speaker
table. Everything runs under `full_f32()`. Entry points run on `device`
("cuda" by default) and raise without a card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.models.duration_model import DurationModel, DurationModelConfig
from efficient_tts_tpu_torch.train.state import apply_updates, create_state, named_params
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32


def split_key(key: int) -> tuple[int, int]:
    """(next key, this step's key) drawn from a CPU generator seeded by `key`."""
    a, b = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(int(key))).tolist()
    return a, b


def _tensor(x, dev) -> torch.Tensor:
    """numpy or a tensor, on `dev`; a tensor already there is not copied."""
    return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(dev)


def init_duration_state(seed: int, cfg: DurationModelConfig, tx, device="cuda") -> dict:
    dev = resolve_device(device)
    model = compat.duration_model_from_jax(init.init_duration_model(seed, cfg), cfg, device=dev, trainable=True)
    return {**create_state(model, tx), "rng": split_key(seed)[0]}


def make_duration_train_step(cfg: DurationModelConfig, tx, device="cuda"):
    dev = resolve_device(device)

    def train_step(state, batch):
        model = state["params"]
        if not isinstance(model, DurationModel) or model.cfg != cfg:
            raise TypeError(f"train_step trains a DurationModel of {cfg}")
        check_module_device(model, dev)
        rng, step_key = split_key(state["rng"])
        b = {k: _tensor(batch[k], dev) for k in ("ppg", "lengths", "durations")}
        spkids = _tensor(batch["spkids"], dev) if cfg.num_spks else None
        params = named_params(model)
        with full_f32():
            out = model(b["ppg"].float(), b["lengths"], b["durations"], spkids=spkids,
                        gen=torch.Generator().manual_seed(step_key), deterministic=False)
            grads = torch.autograd.grad(out["loss"], list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
            apply_updates(state, grads, tx)
        state["rng"] = rng
        return state, {"loss": out["loss"].detach()}

    return train_step
