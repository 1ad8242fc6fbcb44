"""Multi-rank synthesis and serving: process groups, the [data, model] mesh
of ranks, the sharding rules and column-parallel execution (counterpart of
`efficient_tts_tpu/parallel/`)."""

from efficient_tts_tpu_torch.parallel.distributed import initialize_multihost, is_primary, rank_device  # noqa: F401
from efficient_tts_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, fit_data_extent, make_mesh  # noqa: F401
from efficient_tts_tpu_torch.parallel.sharding import (gather_batch, param_specs, shard_module,  # noqa: F401
                                                       split_batch)
