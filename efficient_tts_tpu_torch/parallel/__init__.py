"""Multi-rank synthesis, serving and training: process groups, the [data,
model] mesh of ranks, the sharding rules, column-parallel execution and
sequence parallelism (counterpart of `efficient_tts_tpu/parallel/`)."""

from efficient_tts_tpu_torch.parallel.distributed import initialize_multihost, is_primary, rank_device  # noqa: F401
from efficient_tts_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, data_seed,  # noqa: F401
                                                   fit_data_extent, make_mesh)
from efficient_tts_tpu_torch.parallel.sharding import (gather_batch, gather_state_dict,  # noqa: F401
                                                       gather_train_state, param_specs, shard_module, slice_saved,
                                                       split_batch)
