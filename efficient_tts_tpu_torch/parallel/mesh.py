"""A [data, model] grid of ranks and its process groups.

Counterpart of `efficient_tts_tpu/parallel/mesh.py`. Where JAX lays devices
out in a `jax.sharding.Mesh` and GSPMD inserts the collectives, a port mesh
lays the ranks of the default process group out row-major as [data, model]
and holds the groups the port's collectives run over:

  data  -- the batch is split over it: `data_group` holds the ranks with this
           rank's model index;
  model -- channels (tp) or mel frames (sp) are split over it: `model_group`
           holds the ranks with this rank's data index.

`torch.distributed.new_group` is collective: every rank of the world creates
every group, in the same order, even the groups it is not in. A rank beyond
data * model takes part in that and is then outside the mesh (`member` is
False), with no indices and no groups.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_layout(n: int, data: int | None = None, model: int = 1) -> np.ndarray:
    """The [data, model] grid of the first data * model of n ranks, row-major,
    as JAX reshapes its device list; `data=None` takes every rank that
    `model` leaves."""
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} ranks")
    return np.arange(data * model).reshape(data, model)


class Mesh:
    """The grid of ranks, this rank's place in it, and its groups; build it
    with `make_mesh`, which every rank of the world calls alike."""

    def __init__(self, grid: np.ndarray, rank: int, groups: dict):
        self.grid = grid
        self.rank = rank
        self.shape = {DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]}
        where = np.argwhere(grid == rank)
        self.member = len(where) == 1
        self.data_index, self.model_index = (int(i) for i in where[0]) if self.member else (None, None)
        self.data_group = groups[DATA_AXIS].get(self.model_index)
        self.model_group = groups[MODEL_AXIS].get(self.data_index)
        # every rank of the mesh: the serving leader's broadcasts run over it
        self.group = groups["all"] if self.member else None
        self.root = int(grid[0, 0])


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over the default process group's ranks
    (`initialize_multihost` first); every rank must call it with the same
    extents, since it creates the groups collectively."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.distributed.initialize_multihost")
    grid = mesh_layout(dist.get_world_size(), data, model)
    groups = {DATA_AXIS: {}, MODEL_AXIS: {}}
    for j in range(grid.shape[1]):
        groups[DATA_AXIS][j] = dist.new_group([int(r) for r in grid[:, j]])
    for i in range(grid.shape[0]):
        groups[MODEL_AXIS][i] = dist.new_group([int(r) for r in grid[i, :]])
    groups["all"] = dist.new_group([int(r) for r in grid.reshape(-1)])
    return Mesh(grid, dist.get_rank(), groups)


def fit_data_extent(batch_size: int, n_available: int) -> int:
    """Largest divisor of `batch_size` that is <= n_available -- the
    usable data-parallel extent for a given per-step batch."""
    for d in range(min(batch_size, n_available), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def data_seed(seed: int, mesh=None) -> int:
    """The seed of this rank's dropout generator: `seed` itself on data row 0
    (and without a mesh, so one data row draws as one card does), and one
    drawn from (seed, data index) on the other rows; equal across a model
    row, whose replicated compute must draw the same masks."""
    if mesh is None or not mesh.data_index:
        return seed
    return int(np.random.SeedSequence([seed, mesh.data_index]).generate_state(1)[0])
