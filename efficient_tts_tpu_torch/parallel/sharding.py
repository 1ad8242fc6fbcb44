"""Sharding rules on the port's modules, and the batch split over ranks.

Counterpart of `efficient_tts_tpu/parallel/sharding.py`. JAX's rule: a leaf
of rank >= 2 whose output-channel extent is > 1 and divisible by the model
extent is sharded over 'model'; everything else (biases, norm scales) is
replicated. JAX's kernels are WIO, so it shards their last axis; the port's
tensors are torch-laid, so the rule is applied by meaning, with each
module's own output axis:

  Linear [out, in]                     -> axis 0
  Conv1d [out, in, k]                  -> axis 0
  ConvTranspose1d [in, out, k]         -> axis 1
  the acoustic models' text_embedding [V, C]  -> axis 1
  MRFStage weight / weight_bf16, flat: per conv [k, C_out, C_in] -> axis 1
  of each conv; its biases [n_convs, C] are 18 biases, replicated.

A leaf of rank >= 2 that no rule covers raises, rather than being
replicated where JAX would shard it. `shard_module` builds the rank's
column-parallel copy (`parallel/tensor_parallel.py`); `split_batch` and
`gather_batch` are JAX's `batch_sharding` and its gather.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer
from efficient_tts_tpu_torch.models.hifigan import MRFStage
from efficient_tts_tpu_torch.nn.layers import Conv1d, ConvTranspose1d, LayerNorm, Linear
from efficient_tts_tpu_torch.parallel.mesh import MODEL_AXIS
from efficient_tts_tpu_torch.parallel.tensor_parallel import (ColumnParallelConv1d, ColumnParallelConvTranspose1d,
                                                              ColumnParallelLinear, ColumnParallelMRFStage,
                                                              all_gather_cat, shard_embedding)

# each module type's tensors: (name, output axis or None = replicated)
_RULES = {
    Linear: (("weight", 0), ("bias", None)),
    Conv1d: (("weight", 0), ("bias", None)),
    ConvTranspose1d: (("weight", 1), ("bias", None)),
    LayerNorm: (("scale", None), ("bias", None)),
    MRFStage: (("weight", 1), ("weight_bf16", 1), ("bias", None)),
    EftsCNN: (("text_embedding", 1),),
    EftsTransformer: (("text_embedding", 1), ("pe_scale", None)),
}
_COLUMN_PARALLEL = {Linear: ColumnParallelLinear, Conv1d: ColumnParallelConv1d,
                    ConvTranspose1d: ColumnParallelConvTranspose1d}


def _output_extent(module: nn.Module, t: torch.Tensor, axis: int) -> int:
    return module.channels if isinstance(module, MRFStage) else t.shape[axis]


def param_specs(module: nn.Module, mesh) -> dict:
    """{name: output axis, or None where replicated} for every parameter and
    buffer of `module`, named as `module.state_dict()` names them; a flat
    MRF weight's axis is that of each conv's [k, C_out, C_in] view."""
    m = mesh.shape[MODEL_AXIS]
    specs = {}
    for prefix, mod in module.named_modules():
        rules = dict(_RULES.get(type(mod), ()))
        for name, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            full = f"{prefix}.{name}" if prefix else name
            if name in rules:
                axis = rules[name]
            elif t.dim() < 2:
                axis = None
            else:
                raise ValueError(f"no sharding rule for {full} of {type(mod).__name__} {tuple(t.shape)}")
            if axis is not None:
                extent = _output_extent(mod, t, axis)
                axis = axis if extent > 1 and extent % m == 0 else None
            specs[full] = axis
    return specs


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """This rank's copy of `module` for tensor parallelism over the mesh's
    'model' axis: each leaf `param_specs` shards holds the rank's slice of
    its output channels, and its layer gathers them after computing
    (`parallel/tensor_parallel.py`). Replicated tensors are shared with
    `module`, not copied; `module` itself is left whole. Over a model extent
    of 1 there is nothing to split: `module` comes back as it is."""
    m = mesh.shape[MODEL_AXIS]
    if m == 1:
        return module
    specs = param_specs(module, mesh)
    index, group = mesh.model_index, mesh.model_group

    def rebuild(mod: nn.Module, prefix: str) -> nn.Module:
        weight_spec = specs.get(prefix + "weight")
        if type(mod) in _COLUMN_PARALLEL and weight_spec is not None:
            return _COLUMN_PARALLEL[type(mod)](mod, weight_spec, index, m, group)
        if isinstance(mod, MRFStage) and weight_spec is not None:
            return ColumnParallelMRFStage(mod, index, m, group)
        clone = copy.copy(mod)
        clone._parameters, clone._buffers = dict(mod._parameters), dict(mod._buffers)
        clone._modules = {name: rebuild(child, f"{prefix}{name}.") for name, child in mod._modules.items()}
        if isinstance(mod, (EftsCNN, EftsTransformer)) and specs[prefix + "text_embedding"] is not None:
            shard_embedding(clone, index, m, group)
        return clone

    return rebuild(module, "")


def _rows(n: int, mesh) -> slice:
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"batch of {n} not divisible by the mesh data extent {d}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}")
    k = n // d
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def split_batch(x, mesh):
    """This rank's contiguous block of x's rows (a tensor or an array), the
    block of its data index, as JAX's `batch_sharding` places them."""
    return x[_rows(len(x), mesh)]


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of `split_batch`: every data row's block, gathered over
    `data_group` in data-index order."""
    return all_gather_cat(x, mesh.data_group, dim=0)
