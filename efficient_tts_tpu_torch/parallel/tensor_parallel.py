"""Column-parallel execution: the port's form of JAX's tensor parallelism.

Under JAX's "tp" mode GSPMD partitions each channel-sharded kernel and
inserts the all-gathers. Here a sharded layer holds its rank's slice of the
output channels, computes those channels and all-gathers them along the
channel axis over the mesh's `model_group`, so every rank goes on with the
whole activation; a layer left unsharded runs whole. Biases stay replicated,
as JAX's rule keeps them (a rank adds its slice of the bias).

Each class keeps the parameter and buffer names of the layer it replaces, so
a sharded module's state dict names what the whole one's does.
`ColumnParallelMRFStage` runs its convs through `nn/layers.py:conv1d` (cuDNN
on the card) in `ops/mrf.py:stage_chain`'s order: the MRF kernels take only
square [k, C, C] weights, and JAX's tp path reaches no Pallas kernel either
(`efficient_tts_tpu/pipeline.py:_sharded_synth_fn`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.nn.layers import conv1d, conv_transpose1d, leaky_relu, linear
from efficient_tts_tpu_torch.ops.mrf import LRELU_SLOPE, stage_chain


# neither NCCL nor gloo carries int16 (the engine's PCM): its bytes travel as uint8
_AS_BYTES = (torch.int16,)


def all_gather(x: torch.Tensor, group, async_op: bool = False):
    """x from every rank of `group` (each rank's x of one shape), in
    group-rank order; with `async_op`, (the pending work, the list it fills,
    valid once the work is waited for)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype in _AS_BYTES and x.dim() else x
    bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    work = dist.all_gather(bufs, wire, group=group, async_op=async_op)
    parts = [b.view(x.dtype) for b in bufs]
    return (work, parts) if async_op else parts


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x from every rank of `group`, concatenated along `dim` in group-rank order."""
    return torch.cat(all_gather(x, group), dim=dim)


def _slice(t: torch.Tensor, axis: int, index: int, extent: int) -> torch.Tensor:
    n = t.shape[axis] // extent
    return t.narrow(axis, index * n, n).clone()


class _ColumnParallel(nn.Module):
    """The rank's slice of a layer's weight along its output axis, the whole
    bias, and the group its outputs are gathered over."""

    def __init__(self, layer: nn.Module, axis: int, index: int, extent: int, group):
        super().__init__()
        self.weight = nn.Parameter(_slice(layer.weight, axis, index, extent), requires_grad=False)
        self.bias = layer.bias
        n = self.weight.shape[axis]
        self.cols = slice(index * n, (index + 1) * n)
        self.group = group

    def forward(self, x):
        return all_gather_cat(self.local(x), self.group, dim=-1)


class ColumnParallelLinear(_ColumnParallel):
    def local(self, x):
        return linear(x, self.weight, self.bias[self.cols])


class ColumnParallelConv1d(_ColumnParallel):
    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, axis, index, extent, group)
        self.dilation = layer.dilation

    def local(self, x):
        return conv1d(x, self.weight, self.bias[self.cols], self.dilation)


class ColumnParallelConvTranspose1d(_ColumnParallel):
    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, axis, index, extent, group)
        self.stride, self.padding = layer.stride, layer.padding

    def local(self, x):
        return conv_transpose1d(x, self.weight, self.bias[self.cols], self.stride, self.padding)


class ColumnParallelMRFStage(nn.Module):
    """An MRF stage holding, per conv, the rank's output channels of its
    [k, C_out, C_in] weight (flat, in `MRFStage`'s order; the bf16 copy too)
    and the whole biases [n_convs, C]. Each conv computes the rank's channels
    and gathers them; residuals, branch sums and the average run whole on
    every rank, in `stage_chain`'s order."""

    def __init__(self, stage: nn.Module, index: int, extent: int, group):
        super().__init__()
        self.channels = stage.channels
        self.kernel_sizes, self.dilation_sizes = stage.kernel_sizes, stage.dilation_sizes
        ws = stage.conv_weights(torch.float32)
        self.shapes = [(k, c_out // extent, c_in) for k, c_out, c_in in stage.shapes]
        flat = torch.cat([_slice(w, 1, index, extent).reshape(-1) for w in ws])
        self.register_buffer("weight", flat)
        self.register_buffer("weight_bf16", flat.to(torch.bfloat16))
        self.register_buffer("bias", stage.bias)
        n = self.channels // extent
        self.cols = slice(index * n, (index + 1) * n)
        self.group = group

    def conv_weights(self, dtype) -> list:
        flat = self.weight_bf16 if dtype == torch.bfloat16 else self.weight.to(dtype)
        return [w.view(s) for w, s in zip(flat.split([k * a * b for k, a, b in self.shapes]), self.shapes)]

    def forward(self, x, impl: str = "kernel"):
        """`impl` is accepted for `MRFStage`'s signature: no kernel takes a
        column slice, so both run the convs here."""
        if impl not in ("kernel", "plain"):
            raise ValueError(f"mrf_impl must be 'kernel' or 'plain', got {impl!r}")
        ws = self.conv_weights(x.dtype)
        bias = self.bias[:, self.cols]

        def conv(a, i, d):
            y = conv1d(leaky_relu(a, LRELU_SLOPE), ws[i].permute(1, 2, 0), bias[i], d)
            return all_gather_cat(y, self.group, dim=-1)

        return stage_chain(x, conv, self.dilation_sizes)


def shard_embedding(model: nn.Module, index: int, extent: int, group) -> None:
    """Keep the rank's columns of `model.text_embedding` [V, C] and make the
    model's `embed` look them up and gather the channels."""
    model._parameters["text_embedding"] = nn.Parameter(_slice(model.text_embedding, 1, index, extent),
                                                       requires_grad=False)
    model.embed = lambda text: all_gather_cat(F.embedding(text, model.text_embedding), group, dim=-1)
