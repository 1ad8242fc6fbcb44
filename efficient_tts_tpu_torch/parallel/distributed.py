"""Process groups: one process per rank, the PyTorch idiom.

Counterpart of `efficient_tts_tpu/parallel/distributed.py`. JAX drives every
local device from one process after `jax.distributed.initialize`; here each
rank is a process of its own, joined to the others by
`torch.distributed.init_process_group` (NCCL between cards, gloo on the CPU),
and it runs on the one card `rank_device` gives it. The environment protocol
is torchrun's (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), the
reference's launcher's, which the JAX docstring cites.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, *, backend: str | None = None,
                         device="cuda") -> None:
    """Join this process to the default process group; a second call logs
    and returns.

    With explicit arguments the rendezvous is `coordinator_address`
    ("host:port" for TCP, or a URL such as "file:///path" or "tcp://host:port")
    with `num_processes` ranks, this one `process_id`. Without them it reads
    torchrun's environment. The backend is "nccl" for device="cuda" (the
    default, which raises without a card) and "gloo" for device="cpu", unless
    `backend` names one (gloo also carries CUDA tensors)."""
    if dist.is_initialized():
        log.info("torch.distributed already initialized: rank %d of %d (%s)", dist.get_rank(),
                 dist.get_world_size(), dist.get_backend())
        return
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the ranks on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"no rendezvous: {', '.join(missing)} unset; launch with torchrun or pass "
                               "coordinator_address, num_processes and process_id")
        dist.init_process_group(backend, init_method="env://")
    elif any(a is None for a in explicit):
        raise ValueError("pass coordinator_address, num_processes and process_id together, or none of them")
    else:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes), rank=int(process_id))
    log.info("rank %d of %d on %s", dist.get_rank(), dist.get_world_size(), backend)


def rank_device(device="cuda", index: int | None = None) -> torch.device:
    """This rank's device: for "cuda", the card `index` (by default the
    device's own index, else LOCAL_RANK, else 0). It raises when that card is
    not visible, so two ranks never share a card unless the caller passes the
    same `index` to both; and it raises without a card unless device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the ranks on the CPU")
    if index is None:
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", 0))
    n = torch.cuda.device_count()
    if not 0 <= index < n:
        raise RuntimeError(f"this rank's card cuda:{index} does not exist ({n} visible); start at most one "
                           "rank per card, or pass index= to place ranks on one card on purpose")
    return torch.device("cuda", index)


def is_primary() -> bool:
    """True on rank 0, or in a process that joined no group: the rank that
    logs, saves and binds the server."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_tensors(tensors: dict, group) -> dict:
    """{name: the sum over `group`} of same-dtype tensors, in one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()])
    dist.all_reduce(flat, group=group)
    return {n: v.view_as(t) for (n, t), v in zip(tensors.items(), flat.split([t.numel() for t in tensors.values()]))}
