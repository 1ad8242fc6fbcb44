"""Train state {params, opt_state, step} (counterpart of `efficient_tts_tpu/train/state.py`).

`params` is the model itself: its trainable parameters are the parameter
tree, named as `named_parameters` names them. `opt_state` is the
optimizer's state for those names and `step` a host int. Unlike the JAX
state, which is rebuilt each step, this one is updated in place: the
parameters take their updates with `add_`, which keeps one copy of the
weights on the card. An optimizer that has `update_in_place`
(`train/optim.py:AdamWarmup`: the fused kernels on the card) updates the
parameters and its moments itself.
"""

from __future__ import annotations

import torch


def named_params(model: torch.nn.Module) -> dict:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def create_state(model: torch.nn.Module, tx) -> dict:
    params = named_params(model)
    if not params:
        raise ValueError(f"{type(model).__name__} has no trainable parameters; build it with trainable=True")
    return {"params": model, "opt_state": tx.init(params), "step": 0}


@torch.no_grad()
def apply_updates(state: dict, grads: dict, tx, norm: torch.Tensor | None = None) -> dict:
    """One update of `tx`; `norm`, the gradients' global norm where the
    caller has it, goes to its clip (`train/optim.py:ClipByGlobalNorm`)."""
    params = named_params(state["params"])
    if hasattr(tx, "update_in_place"):
        state["opt_state"] = tx.update_in_place(grads, state["opt_state"], params, norm)
    else:
        kw = {} if norm is None else {"norm": norm}
        updates, state["opt_state"] = tx.update(grads, state["opt_state"], params, **kw)
        for n, u in updates.items():
            params[n].add_(u)
    state["step"] += 1
    return state
