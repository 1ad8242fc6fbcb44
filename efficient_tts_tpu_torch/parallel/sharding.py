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
  of each conv; its biases [n_convs, C] are 18 biases, replicated;
  WNConv1d v [out, in, k] and g [out, 1, 1]  -> axis 0 (JAX's g is [1, 1, out])
  WNConvTranspose1d v [in, out, k]      -> axis 1; g [in, 1, 1] whole (JAX's
  g is [1, in, 1], whose last axis is 1).

A leaf of rank >= 2 that no rule covers raises, rather than being
replicated where JAX would shard it. `shard_module` builds the rank's
column-parallel copy (`parallel/tensor_parallel.py`), for synthesis or
training; `gather_state_dict` and `gather_train_state` gather a
sharded module or train state back into the one-card one (for
checkpoints), `slice_saved` cuts a one-card checkpoint into the rank's
slices; `split_batch` and `gather_batch` are JAX's `batch_sharding` and its
gather. `sharded_names`, `agree_replicated` and `sharded_grad_norm` serve
the tp train steps.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer
from efficient_tts_tpu_torch.models.hifigan import MRFStage
from efficient_tts_tpu_torch.nn.layers import (Conv1d, ConvTranspose1d, LayerNorm, Linear, WNConv1d,
                                               WNConvTranspose1d)
from efficient_tts_tpu_torch.parallel.distributed import all_reduce_tensors
from efficient_tts_tpu_torch.parallel.mesh import MODEL_AXIS
from efficient_tts_tpu_torch.parallel.tensor_parallel import (ColumnParallelConv1d, ColumnParallelConvTranspose1d,
                                                              ColumnParallelLinear, ColumnParallelMRFStage,
                                                              ColumnParallelWNConv1d, ColumnParallelWNConvTranspose1d,
                                                              _slice, all_gather_cat, shard_embedding)

# each module type's tensors: (name, output axis or None = replicated)
_RULES = {
    Linear: (("weight", 0), ("bias", None)),
    Conv1d: (("weight", 0), ("bias", None)),
    ConvTranspose1d: (("weight", 1), ("bias", None)),
    WNConv1d: (("v", 0), ("g", 0), ("bias", None)),
    WNConvTranspose1d: (("v", 1), ("g", None), ("bias", None)),
    LayerNorm: (("scale", None), ("bias", None)),
    MRFStage: (("weight", 1), ("weight_bf16", 1), ("bias", None)),
    EftsCNN: (("text_embedding", 1),),
    EftsTransformer: (("text_embedding", 1), ("pe_scale", None)),
}
_COLUMN_PARALLEL = {Linear: ColumnParallelLinear, Conv1d: ColumnParallelConv1d,
                    ConvTranspose1d: ColumnParallelConvTranspose1d, WNConv1d: ColumnParallelWNConv1d,
                    WNConvTranspose1d: ColumnParallelWNConvTranspose1d}
# the tensor whose spec decides whether a layer is split
_SPLIT_BY = {WNConv1d: "v", WNConvTranspose1d: "v"}


def _output_extent(module: nn.Module, t: torch.Tensor, axis: int) -> int:
    return module.channels if isinstance(module, MRFStage) else t.shape[axis]


def param_specs(module: nn.Module, mesh) -> dict:
    """{name: output axis, or None where replicated} for every parameter and
    buffer of `module`, named as `module.state_dict()` names them; a flat
    MRF weight's axis is that of each conv's [k, C_out, C_in] view."""
    m = mesh.shape[MODEL_AXIS]
    specs = {}
    for prefix, mod in module.named_modules(remove_duplicate=False):
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


def shard_module(module: nn.Module, mesh, trainable: bool = False) -> nn.Module:
    """This rank's copy of `module` for tensor parallelism over the mesh's
    'model' axis: each leaf `param_specs` shards holds the rank's slice of
    its output channels, as trainable as the leaf it was cut from, and its
    layer gathers them after computing (`parallel/tensor_parallel.py`); the
    copy's `shard_specs` are the specs of the whole module. Replicated
    tensors are shared with `module`; with `trainable` the copy is cut from
    a deep copy instead, so training it leaves `module` as it was. Over a
    model extent of 1 there is nothing to split: `module` comes back as it
    is."""
    m = mesh.shape[MODEL_AXIS]
    if m == 1:
        return module
    specs = param_specs(module, mesh)
    index, group = mesh.model_index, mesh.model_group
    if trainable:
        module = copy.deepcopy(module)
    built = {}  # a module reached under two names (a shared key and value) is built once

    def rebuild(mod: nn.Module, prefix: str) -> nn.Module:
        if id(mod) in built:
            return built[id(mod)]
        spec = specs.get(prefix + _SPLIT_BY.get(type(mod), "weight"))
        if type(mod) in _COLUMN_PARALLEL and spec is not None:
            out = _COLUMN_PARALLEL[type(mod)](mod, spec, index, m, group)
        elif isinstance(mod, MRFStage) and spec is not None:
            out = ColumnParallelMRFStage(mod, index, m, group)
        else:
            out = copy.copy(mod)
            out._parameters, out._buffers = dict(mod._parameters), dict(mod._buffers)
            out._modules = {name: rebuild(child, f"{prefix}{name}.") for name, child in mod._modules.items()}
            if isinstance(mod, (EftsCNN, EftsTransformer)) and specs[prefix + "text_embedding"] is not None:
                shard_embedding(out, index, m, group)
        built[id(mod)] = out
        return out

    out = rebuild(module, "")
    out.shard_specs = specs
    return out


def _specs_of(module: nn.Module) -> dict:
    return getattr(module, "shard_specs", None) or {}


def gather_state_dict(module: nn.Module, mesh) -> dict:
    """The whole module's state dict from a `shard_module` copy: each
    sharded tensor gathered over the model group along its axis
    (collective: every rank of the model row calls it). A module that was
    not split gives its own state dict."""
    specs = _specs_of(module)
    return {k: all_gather_cat(v, mesh.model_group, specs[k]) if specs.get(k) is not None else v
            for k, v in module.state_dict().items()}


def sharded_names(module: nn.Module) -> set:
    """The names of the leaves a `shard_module` copy holds as slices (none
    for a module that was not split)."""
    return {n for n, a in _specs_of(module).items() if a is not None}


def agree_replicated(grads: dict, sharded, mesh) -> dict:
    """Under tp, the replicated leaves' gradients averaged over the model
    group. The ranks of a model row compute them from the same inputs, but
    cuDNN may take a convolution algorithm that sums in a run-dependent
    order, and a last-bit difference would let the row's copies of a
    replicated parameter drift apart."""
    m = mesh.shape[MODEL_AXIS]
    whole = {n: g for n, g in grads.items() if n not in sharded}
    if m == 1 or not whole:
        return grads
    return {**grads, **{n: g / m for n, g in all_reduce_tensors(whole, mesh.model_group).items()}}


def sharded_grad_norm(grads: dict, sharded, group) -> torch.Tensor:
    """The global norm of a rank's gradients whose `sharded` leaves are its
    slices: those leaves' squares summed over the model `group`, the
    replicated ones counted once."""
    zero = [torch.zeros((), device=next(iter(grads.values())).device)]
    split = torch.stack([torch.sum(g * g) for n, g in grads.items() if n in sharded] + zero).sum()
    dist.all_reduce(split, group=group)
    whole = torch.stack([torch.sum(g * g) for n, g in grads.items() if n not in sharded] + zero).sum()
    return torch.sqrt(split + whole)


def _map_named(tree, fn):
    """`tree` (an optimizer state: dicts and lists) with fn(name, tensor)
    applied to each tensor held under a name."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if torch.is_tensor(v) else _map_named(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn) for v in tree)
    return tree


def _gather_tree(state, mesh, specs):
    def gather(name, t):
        axis = specs.get(name)
        return all_gather_cat(t, mesh.model_group, axis) if axis is not None else t
    return _map_named(state, gather)


def gather_train_state(state: dict, mesh) -> dict:
    """A train state ({params, opt_state, step}, or the GAN's {gen, disc,
    step[, ema]}) gathered into what one card's state saves: every module as
    the whole module's state dict, every optimizer state's moments whole
    (collective over the model group)."""
    out = {}
    for key, value in state.items():
        if isinstance(value, nn.Module):
            out[key] = gather_state_dict(value, mesh)
        elif key == "opt_state":
            out[key] = _gather_tree(value, mesh, _specs_of(state["params"]))
        elif isinstance(value, dict):
            out[key] = gather_train_state(value, mesh)
        else:
            out[key] = value
    return out


def slice_saved(saved: dict, state: dict, mesh) -> dict:
    """A one-card checkpoint's contents cut to this rank's slices wherever
    `state` holds a sharded module (and its optimizer state), ready for
    `train/checkpoint.py:restore`."""
    m, index = mesh.shape[MODEL_AXIS], mesh.model_index

    def cut(specs):
        return lambda name, t: _slice(t, specs[name], index, m) if specs.get(name) is not None else t

    out = dict(saved)
    for key, value in state.items():
        if key not in saved:
            continue
        if isinstance(value, nn.Module):
            out[key] = {k: cut(_specs_of(value))(k, t) for k, t in saved[key].items()}
        elif key == "opt_state":
            out[key] = _map_named(saved[key], cut(_specs_of(state["params"])))
        elif isinstance(value, dict):
            out[key] = slice_saved(saved[key], value, mesh)
    return out


def _rows(n: int, mesh) -> slice:
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"batch of {n} not divisible by the mesh data extent {d}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}")
    k = n // d
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def split_batch(x, mesh, accum_steps: int = 1):
    """This rank's rows of x (a tensor or an array), as JAX places them: the
    contiguous block of its data index (`batch_sharding`); with
    `accum_steps`, x is first cut into that many micro-batches, and the rank
    takes its block of each, in micro-batch order."""
    if accum_steps == 1:
        return x[_rows(len(x), mesh)]
    if len(x) % accum_steps:
        raise ValueError(f"batch of {len(x)} not divisible by accum_steps={accum_steps}")
    n = len(x) // accum_steps
    rows = _rows(n, mesh)
    parts = [x[i * n:(i + 1) * n][rows] for i in range(accum_steps)]
    return torch.cat(parts) if torch.is_tensor(x) else np.concatenate(parts)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of `split_batch`: every data row's block, gathered over
    `data_group` in data-index order."""
    return all_gather_cat(x, mesh.data_group, dim=0)
