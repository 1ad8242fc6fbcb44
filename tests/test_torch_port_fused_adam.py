"""The fused optimizer's choice of path and its leaf table, on the CPU.

`train/state.py:apply_updates` (through `AdamWarmup.update_in_place`) and
`train/optim.py:grad_norm` take the per-tensor path for CPU tensors, with
the fused kernels' launch and copy counters left at 0.
`ops/fused_adam.py:plan` splits ragged leaves into launches and chunks
that cover every element exactly once. The kernels themselves run on the
card (`test_torch_port_fused_adam_cuda.py`).
"""

import numpy as np
import pytest
import torch

from efficient_tts_tpu_torch.ops import fused_adam
from efficient_tts_tpu_torch.train.optim import AdamWarmup, HiFiGANAdam, global_norm, grad_norm
from efficient_tts_tpu_torch.train.state import apply_updates, create_state, named_params


class Leaves(torch.nn.Module):
    """Parameters of `shapes`, N(0, 0.01) from `seed`, on the CPU."""

    def __init__(self, shapes, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.ps = torch.nn.ParameterList(torch.nn.Parameter(0.1 * torch.randn(s, generator=g)) for s in shapes)


@pytest.mark.parametrize("tx", [AdamWarmup(weight_decay=1e-5, amsgrad=True, grad_clip_norm=1.0, warmup_steps=4),
                                HiFiGANAdam()], ids=["recipe", "hifigan"])
def test_apply_updates_on_cpu_takes_the_per_tensor_path(tx):
    torch.manual_seed(0)
    shapes = [(3, 5), (7,), (2, 3, 4), (1,)]
    state = create_state(Leaves(shapes, seed=0), tx)
    ref = {n: p.detach().clone() for n, p in named_params(state["params"]).items()}
    ref_opt = tx.init(ref)
    fused_adam.reset_launches()
    for step in range(3):
        grads = {n: 2.0 * torch.randn(p.shape) for n, p in ref.items()}
        norm = grad_norm(grads)
        assert torch.equal(norm, global_norm(list(grads.values())))
        apply_updates(state, grads, tx)
        updates, ref_opt = tx.update(grads, ref_opt, ref)
        ref = {n: ref[n] + updates[n] for n in ref}
        for n, p in named_params(state["params"]).items():
            assert torch.equal(p.detach(), ref[n]), (step, n)
    assert state["step"] == 3 and state["opt_state"]["count"] == ref_opt["count"] == 3
    assert fused_adam.launches == {} and fused_adam.copied_leaves == {}


def _chunks(sizes, starts, chunk):
    """(leaf, start, stop) of each chunk of a group, found as the kernel
    finds them (csrc/fused_adam.cu:locate): block b takes chunks b, b +
    grid, ..., its leaf index moving forward only."""
    out, total, grid = [], int(starts[-1]), 3
    for b in range(grid):
        leaf = 0
        for c in range(b, total, grid):
            while c >= starts[leaf + 1]:
                leaf += 1
            start = (c - int(starts[leaf])) * chunk
            out.append((leaf, start, min(start + chunk, sizes[leaf])))
    return out


@pytest.mark.parametrize("sizes,max_leaves,chunk", [
    ([1, 1, 80, 384, 4096, 4097, 1769472, 3], 256, 4096),
    ([0, 5, 0, 0, 9, 16, 17, 0], 3, 4),
    (list(range(1, 40)), 7, 8),
    ([8, 8, 8], 1, 8),
], ids=["model-like", "empty-leaves", "ragged-groups", "one-leaf-groups"])
def test_plan_covers_every_element_once(sizes, max_leaves, chunk):
    groups = fused_adam.plan(sizes, max_leaves, chunk)
    assert [i for idx, _ in groups for i in idx] == list(range(len(sizes)))
    for idx, starts in groups:
        assert 1 <= len(idx) <= max_leaves and starts.dtype == np.int32 and starts[0] == 0
        local = [sizes[i] for i in idx]
        seen = [np.zeros(n, dtype=np.int64) for n in local]
        for leaf, lo, hi in _chunks(local, starts, chunk):
            assert 0 <= lo < hi <= local[leaf] and hi - lo <= chunk
            seen[leaf][lo:hi] += 1
        assert all((s == 1).all() for s in seen)
