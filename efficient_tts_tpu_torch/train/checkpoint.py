"""Checkpoints of the train state {params, opt_state, step} with `torch.save`.

Counterpart of `efficient_tts_tpu/train/checkpoint.py`: `save_checkpoint`
writes the model's state dict, the optimizer state and the step to
`outdir/checkpoint-{step}steps`; `load_checkpoint` restores everything
(resume) or the parameters only (`load_only_params`, the reference's
--pretrain). A save is written to a temporary name and renamed, so a
checkpoint on disk is always whole. Names that do not match
`checkpoint-{step}steps` (the divergence guard's `diverged-state-{step}`)
are invisible to `latest_checkpoint` and `prune_checkpoints`.
"""

from __future__ import annotations

import os

import torch

_PREFIX, _SUFFIX = "checkpoint-", "steps"


def save_checkpoint(outdir: str, state: dict, name: str | None = None) -> str:
    step = state["step"]
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(os.path.abspath(outdir), name or f"{_PREFIX}{step}{_SUFFIX}")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"params": state["params"].state_dict(), "opt_state": state["opt_state"], "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: dict, load_only_params: bool = False) -> dict:
    """Restore into `state` (its model and device) and return it; with
    `load_only_params` the optimizer state and step stay as they are."""
    model = state["params"]
    device = next(model.parameters()).device
    ckpt = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    model.load_state_dict(ckpt["params"])
    if not load_only_params:
        state["opt_state"] = ckpt["opt_state"]
        state["step"] = int(ckpt["step"])
    return state


def _steps(outdir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(outdir):
        return []
    found = []
    for name in os.listdir(outdir):
        if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
            try:
                found.append((int(name[len(_PREFIX):-len(_SUFFIX)]), name))
            except ValueError:
                continue
    return sorted(found)


def latest_checkpoint(outdir: str) -> str | None:
    """The highest-step checkpoint in `outdir`, or None."""
    found = _steps(outdir)
    return os.path.join(outdir, found[-1][1]) if found else None


def prune_checkpoints(outdir: str, keep: int | None) -> list:
    """Delete all but the newest `keep` checkpoints (by step); `keep=None`
    keeps everything. Returns the removed paths."""
    if not keep:
        return []
    removed = []
    for _, name in _steps(outdir)[:-keep]:
        path = os.path.join(outdir, name)
        os.remove(path)
        removed.append(path)
    return removed
