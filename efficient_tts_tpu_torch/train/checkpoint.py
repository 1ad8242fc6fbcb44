"""Checkpoints of the train state {params, opt_state, step} with `torch.save`.

Counterpart of `efficient_tts_tpu/train/checkpoint.py`: `save_checkpoint`
writes a train state to `outdir/checkpoint-{step}steps`, each module in it
as its state dict (an acoustic model's {params, opt_state, step}; the
vocoder's {gen: {params, opt_state}, disc: {params, opt_state}, step[,
ema]}); `load_checkpoint` restores everything (resume) or the modules only
(`load_only_params`, the reference's --pretrain). A save is written to a temporary name and renamed, so a
checkpoint on disk is always whole. Names that do not match
`checkpoint-{step}steps` (the divergence guard's `diverged-state-{step}`)
are invisible to `latest_checkpoint` and `prune_checkpoints`.
`save_train_state` is the trainers' save, on one card or over ranks.

Saves can overlap training, as JAX's orbax checkpointer's do: a save first
copies every tensor of the state to host memory on the caller's thread (the
state dicts share storage with the live parameters and optimizer moments,
which the next step updates in place), then `wait=False` hands the write
and the rename to one worker thread and returns. At most one save is in
flight: the next save, `wait_for_saves`, every read (`read_checkpoint`,
`latest_checkpoint`) and pruning wait for it first, and raise the
writer's error if it failed. `wait_for_saves` also runs at exit.
"""

from __future__ import annotations

import atexit
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import torch
import torch.distributed

_PREFIX, _SUFFIX = "checkpoint-", "steps"
_LOCK = threading.Lock()
_WRITER: ThreadPoolExecutor | None = None
_PENDING: Future | None = None  # the save in flight


def _saved(state):
    if isinstance(state, torch.nn.Module):
        return state.state_dict()
    if isinstance(state, dict):
        return {k: _saved(v) for k, v in state.items()}
    return state


def _host_copy(tree):
    """`tree` with every tensor copied to host memory (a copy even of a CPU
    tensor); containers keep their type, and a state dict its metadata."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        out = type(tree)((k, _host_copy(v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _write(path: str, snapshot: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(snapshot, tmp)
    os.replace(tmp, path)


def wait_for_saves() -> None:
    """Block until the save in flight, if any, is on disk; raise its
    writer's error, once."""
    global _PENDING
    with _LOCK:
        pending, _PENDING = _PENDING, None
    if pending is not None:
        pending.result()


def checkpoint_path(outdir: str, step: int, name: str | None = None) -> str:
    """Where `save_checkpoint` writes the state of `step` (or `name`)."""
    return os.path.join(os.path.abspath(outdir), name or f"{_PREFIX}{int(step)}{_SUFFIX}")


def save_checkpoint(outdir: str, state: dict, name: str | None = None, wait: bool = True) -> str:
    """Write `state` and return the path. The host snapshot is taken before
    this returns; `wait=False` returns before the disk write ends (read the
    path back through `read_checkpoint`, or after `wait_for_saves`)."""
    global _PENDING, _WRITER
    step = int(state["step"])
    os.makedirs(outdir, exist_ok=True)
    path = checkpoint_path(outdir, step, name)
    wait_for_saves()
    snapshot = {**_host_copy(_saved(state)), "step": step}
    if wait:
        _write(path, snapshot)
        return path
    with _LOCK:
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(1, thread_name_prefix="checkpoint-writer")
            atexit.register(wait_for_saves)
        _PENDING = _WRITER.submit(_write, path, snapshot)
    return path


def save_train_state(outdir: str, state: dict, name: str | None = None, mesh=None,
                     keep: int | None = None, wait: bool = True) -> str:
    """Save a trainer's state and prune to the newest `keep` (which waits
    for the write); returns the path. Under a `mesh` this is collective: the
    one-card state is gathered (`parallel/sharding.py:gather_train_state`)
    and rank 0 alone writes it, in the background with `wait=False`; the
    ranks' barrier does not wait for the write (a load waits for it:
    `wait_for_saves` on rank 0, then `settle`'s barrier)."""
    from efficient_tts_tpu_torch.parallel.distributed import is_primary
    from efficient_tts_tpu_torch.parallel.sharding import gather_train_state

    if mesh is not None:
        state = gather_train_state(state, mesh)
    path = checkpoint_path(outdir, state["step"], name)
    if is_primary():
        save_checkpoint(outdir, state, name=name, wait=wait)
        if keep:
            prune_checkpoints(outdir, keep)
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)
    return path


def settle(mesh=None) -> None:
    """Before a load: this process's save in flight on disk, and under a
    `mesh` every rank past the point where rank 0's is (collective)."""
    wait_for_saves()
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)


def read_checkpoint(path: str, device="cpu") -> dict:
    """A checkpoint's contents, tensors on `device` (after the save in flight)."""
    wait_for_saves()
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def restore(state: dict, saved: dict, load_only_params: bool = False) -> dict:
    """Load `saved` into `state` key by key: modules by their state dict,
    optimizer states and steps by value (unless `load_only_params`)."""
    for key, value in state.items():
        if isinstance(value, torch.nn.Module):
            value.load_state_dict(saved[key])
        elif isinstance(value, dict) and key != "opt_state":
            restore(value, saved[key], load_only_params)
        elif not load_only_params:
            state[key] = int(saved[key]) if key == "step" else saved[key]
    return state


def state_device(state) -> torch.device:
    """The device of the first module of a train state."""
    for value in state.values():
        if isinstance(value, torch.nn.Module):
            return next(value.parameters()).device
        if isinstance(value, dict):
            dev = state_device(value)
            if dev is not None:
                return dev
    return None


def load_checkpoint(path: str, state: dict, load_only_params: bool = False) -> dict:
    """Restore into `state` (its modules and device) and return it; with
    `load_only_params` the optimizer states and the step stay as they are."""
    return restore(state, read_checkpoint(path, state_device(state)), load_only_params)


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
    """The highest-step checkpoint in `outdir` (after the save in flight), or None."""
    wait_for_saves()
    found = _steps(outdir)
    return os.path.join(outdir, found[-1][1]) if found else None


def prune_checkpoints(outdir: str, keep: int | None) -> list:
    """Delete all but the newest `keep` checkpoints (by step); `keep=None`
    keeps everything. Returns the removed paths."""
    if not keep:
        return []
    wait_for_saves()
    removed = []
    for _, name in _steps(outdir)[:-keep]:
        path = os.path.join(outdir, name)
        os.remove(path)
        removed.append(path)
    return removed
