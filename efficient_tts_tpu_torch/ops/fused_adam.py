"""The train step's optimizer on the card: the multi-tensor kernels' wrapper.

`global_norm` is the gradients' global norm (optax.global_norm) in two
launches; `adam_update` the clip, weight decay and Adam (optionally
amsgrad) update of `train/optim.py:AdamWarmup`, applied to every leaf in
place in one launch. Both take lists of leaves, every one an f32 tensor on
one CUDA device, leaf for leaf of one shape across the lists, and raise
ValueError otherwise (`check_leaves`). A leaf that is not contiguous is
copied to a contiguous one for the launch (and copied back where the
kernel writes it), counted in `copied_leaves`. Lists longer than the
kernels' table (`max_leaves`, 256 leaves) are split over launches.

Replaces no TPU kernel: the JAX package leaves optax's chain to XLA. The
plain version is the per-tensor path: `train/optim.py:global_norm` and
`AdamWarmup.update` followed by one `add_` a leaf, which
`AdamWarmup.update_in_place` takes for CPU tensors. The kernels
(`csrc/fused_adam.cu`) walk a table of (leaf, chunk of CHUNK elements)
with a persistent grid; `plan` builds the table's chunk starts. Given the
same norm, the update equals the per-tensor path's bit for bit; the norm
sums in f64 in a fixed order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from efficient_tts_tpu_torch.ops import launch_counts

CHUNK = 4096  # elements a chunk: csrc/fused_adam.cu:kChunk, checked when the library loads
# kernel launches by key ("norm": partial sums and the finalize; "update")
launches: dict[str, int] = {}
# leaves that were not contiguous and were copied for a launch, by the same keys
copied_leaves: dict[str, int] = {}
_max_blocks: dict[int, int] = {}


def reset_launches() -> None:
    launches.clear()
    copied_leaves.clear()


def plan(sizes, max_leaves: int, chunk: int = CHUNK) -> list[tuple[range, np.ndarray]]:
    """The kernels' tables for leaves of `sizes` elements: groups of at most
    `max_leaves` consecutive leaves, one launch each, as (the group's leaf
    indices, its chunk starts). Leaf i of a group owns chunks [starts[i],
    starts[i + 1]), ceil(size / chunk) of them; chunk c covers elements
    [(c - starts[i]) * chunk, min(size, (c - starts[i] + 1) * chunk))."""
    sizes = [int(s) for s in sizes]
    groups = []
    for lo in range(0, len(sizes), max_leaves):
        idx = range(lo, min(lo + max_leaves, len(sizes)))
        counts = [-(-sizes[i] // chunk) for i in idx]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        if starts[-1] >= 2**31:
            raise ValueError(f"{starts[-1]} chunks exceed the kernels' int32 chunk index")
        groups.append((idx, starts.astype(np.int32)))
    return groups


def check_leaves(*leaf_lists) -> None:
    """Raise ValueError unless the lists (params, grads, moments, ...) hold,
    leaf for leaf, f32 tensors of one shape on the first leaf's CUDA device."""
    first = leaf_lists[0] if leaf_lists else None
    if not first or first[0].device.type != "cuda":
        raise ValueError("the fused optimizer takes CUDA tensors")
    shapes, device = [t.shape for t in first], first[0].device
    for leaves in leaf_lists:
        if [t.shape for t in leaves] != shapes:
            raise ValueError("the fused optimizer's lists differ in their leaves' shapes")
        if any(t.device != device for t in leaves):
            raise ValueError(f"the fused optimizer takes tensors on one CUDA device, not {device} and others")
        if any(t.dtype is not torch.float32 for t in leaves):
            raise ValueError("the fused optimizer takes f32 tensors")


def _contiguous(tensors: list, key: str, written: list | None = None) -> list:
    """`tensors` with each one that is not contiguous replaced by a contiguous
    copy, counted under `key`; with `written`, (tensor, copy) pairs to copy
    back once the kernel has written the copies."""
    out = [t if t.is_contiguous() else t.contiguous() for t in tensors]
    copied = [(t, c) for t, c in zip(tensors, out) if c is not t]
    if copied:
        launch_counts.add(copied_leaves, key, len(copied))
        if written is not None:
            written.extend(copied)
    return out


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("fused_adam")
    if lib.fused_adam_update.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_adam_chunk.restype = i
        lib.fused_adam_max_leaves.restype = i
        lib.fused_adam_max_blocks.argtypes = [p]
        lib.fused_adam_max_blocks.restype = i
        lib.fused_norm_partials.argtypes = [p, p, p, i, p, i, p]
        lib.fused_norm_partials.restype = i
        lib.fused_norm_finalize.argtypes = [p, i, p, p]
        lib.fused_norm_finalize.restype = i
        lib.fused_adam_update.argtypes = [p, p, p, i, p, i, i, p, i, p]
        lib.fused_adam_update.restype = i
        if lib.fused_adam_chunk() != CHUNK:
            raise RuntimeError(f"csrc/fused_adam.cu's chunk is {lib.fused_adam_chunk()}, the wrapper's {CHUNK}")
    return lib


def max_leaves() -> int:
    """Leaves a launch's table holds (the kernel parameter space's limit)."""
    return _lib().fused_adam_max_leaves()


def _grid(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _max_blocks:
        out = ctypes.c_int()
        with torch.cuda.device(index):
            rc = _lib().fused_adam_max_blocks(ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"fused_adam_max_blocks failed: CUDA error {rc}")
        _max_blocks[index] = out.value
    return _max_blocks[index]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _ptrs(tensors) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in tensors), dtype=np.int64, count=len(tensors))


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of every element's square, a f32 device scalar: one
    launch of partial sums a table of leaves, one to add them up."""
    check_leaves(grads)
    grads = _contiguous(grads, "norm")
    lib, dev = _lib(), grads[0].device
    sizes = [g.numel() for g in grads]
    groups = plan(sizes, max_leaves())
    grids = [max(1, min(int(starts[-1]), _grid(dev))) for _, starts in groups]
    partials = torch.empty(sum(grids), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        offset = 0
        for (idx, starts), grid in zip(groups, grids):
            g = _ptrs([grads[i] for i in idx])
            n = np.array([sizes[i] for i in idx], dtype=np.int64)
            _check(lib.fused_norm_partials(g.ctypes.data, n.ctypes.data, starts.ctypes.data, len(idx),
                                           partials.data_ptr() + 8 * offset, grid, stream), "fused_norm_partials")
            launch_counts.add(launches, "norm")
            offset += grid
        _check(lib.fused_norm_finalize(partials.data_ptr(), offset, out.data_ptr(), stream), "fused_norm_finalize")
    launch_counts.add(launches, "norm")
    return out


def _hyper(max_norm, weight_decay, b1, b2, eps, bc1, bc2, step_size) -> np.ndarray:
    """The update's f32 constants (csrc/fused_adam.cu:Hyper), each as PyTorch
    makes the operand from the host float in the per-tensor path: a Python
    float meets an f32 tensor rounded to f32 (1 - b1 computed in f64 first),
    and x / bc becomes x * (1 / f32(bc)) in f32."""
    f = np.float32
    return np.array([f(max_norm or 0.0), f(weight_decay), f(b1), f(1 - b1), f(b2), f(1 - b2),
                     f(1.0) / f(bc1), f(1.0) / f(bc2), f(eps), f(step_size)], dtype=np.float32)


def adam_update(params: list, grads: list, mu: list, nu: list, nu_max: list | None, norm: torch.Tensor | None,
                *, max_norm: float | None, weight_decay: float, b1: float, b2: float, eps: float, bc1: float,
                bc2: float, step_size: float) -> None:
    """One update of every leaf in place: the clip by `norm` (a device
    scalar; None or `max_norm` None for no clip), + weight_decay * p, the
    moments, nu_max = max(nu_max, nu / bc2) where `nu_max` is given
    (amsgrad), p += step_size * (mu / bc1) / (sqrt(nu_hat) + eps)."""
    check_leaves(params, grads, mu, nu, *([nu_max] if nu_max is not None else []))
    written = []
    leaves = [_contiguous(params, "update", written), _contiguous(grads, "update"),
              *(_contiguous(m, "update", written) for m in (mu, nu, nu_max) if m is not None)]
    lib, dev = _lib(), params[0].device
    if max_norm is None:
        norm = None
    elif norm is None:
        raise ValueError("adam_update clips by a norm: pass the gradients' global norm")
    else:
        norm = norm.to(device=dev, dtype=torch.float32).reshape(())
    h = _hyper(max_norm, weight_decay, b1, b2, eps, bc1, bc2, step_size)
    sizes = [t.numel() for t in params]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for idx, starts in plan(sizes, max_leaves()):
            if starts[-1] == 0:
                continue
            ptrs = np.concatenate([_ptrs([lst[i] for i in idx]) for lst in leaves]
                                  + ([] if nu_max is not None else [np.zeros(len(idx), np.int64)]))
            n = np.array([sizes[i] for i in idx], dtype=np.int64)
            _check(lib.fused_adam_update(ptrs.ctypes.data, n.ctypes.data, starts.ctypes.data, len(idx), h.ctypes.data,
                                         int(nu_max is not None), int(bool(weight_decay)),
                                         norm.data_ptr() if norm is not None else None,
                                         min(int(starts[-1]), _grid(dev)), stream), "fused_adam_update")
            launch_counts.add(launches, "update")
        for t, c in written:
            t.copy_(c)
