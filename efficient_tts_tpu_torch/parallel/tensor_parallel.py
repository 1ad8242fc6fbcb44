"""Column-parallel execution: the port's form of JAX's tensor parallelism.

Under JAX's "tp" mode GSPMD partitions each channel-sharded kernel and
inserts the all-gathers. Here a sharded layer holds its rank's slice of the
output channels, computes those channels and all-gathers them along the
channel axis over the mesh's `model_group`, so every rank goes on with the
whole activation; a layer left unsharded runs whole. Biases stay replicated,
as JAX's rule keeps them, and are added after the gather.

One family of layers serves synthesis and training: its collectives are
autograd Functions, as Megatron writes them. The input enters through
`copy_to_group` (identity forward; the backward all-reduces the input
gradient over the model group, each rank holding only its slice's part of
it), and the output leaves through `gather_columns` (an all-gather forward;
the backward keeps the rank's slice of the output gradient, which every
rank holds whole, since everything after the gather is replicated). Under
`torch.no_grad` they are a plain all-gather. A weight-normed transposed conv
normalizes per input channel over (out, k), across the shards: its partial
sums of squares are all-reduced (`all_reduce_sum`) before the division.

Each class keeps the parameter and buffer names of the layer it replaces, so
a sharded module's state dict names what the whole one's does.
`ColumnParallelMRFStage` (synthesis only: its weights are buffers) runs its
convs through `nn/layers.py:conv1d` (cuDNN on the card) in
`ops/mrf.py:stage_chain`'s order: the MRF kernels take only square
[k, C, C] weights, and JAX's tp path reaches no Pallas kernel either
(`efficient_tts_tpu/pipeline.py:_sharded_synth_fn`).

`all_reduce_sum`, `all_gather_stack` and `all_reduce_max` serve sequence
parallelism too (`parallel/sequence_parallel.py`): their backward sums the
ranks' gradients, each rank's loss being its part of the global one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.nn.layers import _WeightNormed, conv1d, conv_transpose1d, leaky_relu, linear
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


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n, ctx.index = dim, x.shape[dim], dist.get_rank(group)
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None


def _summed(g: torch.Tensor, group) -> torch.Tensor:
    g = g.contiguous().clone()
    dist.all_reduce(g, group=group)
    return g


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllGatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.index = group, dist.get_rank(group)
        return torch.stack(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group)[ctx.index], None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.amax(dim=-1).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        tied = x == y[..., None]
        n = tied.sum(dim=-1).to(x.dtype)
        dist.all_reduce(n, group=group)
        ctx.save_for_backward(tied, n)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, g):
        tied, n = ctx.saved_tensors
        return tied * (_summed(g, ctx.group) / n)[..., None], None


def gather_columns(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """x's slices from every rank of `group`, concatenated along `dim`; the
    backward keeps this rank's slice of the (whole, replicated) gradient."""
    return _GatherColumns.apply(x, group, dim % x.dim())


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; the backward all-reduces (sums) its gradient over `group`."""
    return _CopyToGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; the backward sums the gradients over it too."""
    return _AllReduceSum.apply(x, group)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[ranks of `group`, *x.shape]: x of every rank; the backward sums the
    gradients over the group and keeps this rank's row."""
    return _AllGatherStack.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The max of x over its last axis and over `group`; the gradient, summed
    over the group, is spread evenly over every tied maximum of every rank,
    as `jnp.max` spreads it."""
    return _AllReduceMax.apply(x, group)


def _slice(t: torch.Tensor, axis: int, index: int, extent: int) -> torch.Tensor:
    n = t.shape[axis] // extent
    return t.narrow(axis, index * n, n).clone()


def _sliced(t: torch.Tensor, axis: int, index: int, extent: int) -> nn.Parameter:
    return nn.Parameter(_slice(t, axis, index, extent), requires_grad=t.requires_grad)


class _ColumnParallel(nn.Module):
    """A layer holding the rank's slice of its weight along the output axis
    and the whole bias: the input enters through `copy_to_group`, the rank's
    channels (`local` with `kernel()`) leave through `gather_columns`, and the
    bias is added after the gather, the same values as each rank adding its
    slice before it."""

    def __init__(self, layer: nn.Module, group):
        super().__init__()
        self.bias = layer.bias
        self.group = group

    def forward(self, x):
        y = self.local(copy_to_group(x, self.group), self.kernel())
        return gather_columns(y, self.group) + self.bias.to(y.dtype)

    def kernel(self) -> torch.Tensor:
        return self.weight


class ColumnParallelLinear(_ColumnParallel):
    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, group)
        self.weight = _sliced(layer.weight, axis, index, extent)

    def local(self, x, w):
        return linear(x, w, None)


class _Conv(_ColumnParallel):
    def __init__(self, layer, group):
        super().__init__(layer, group)
        self.dilation = layer.dilation
        self.stride, self.groups = getattr(layer, "stride", 1), getattr(layer, "groups", 1)
        self.padding = getattr(layer, "padding", None)

    def local(self, x, w):
        return conv1d(x, w, None, self.dilation, self.stride, self.padding, self.groups)


class ColumnParallelConv1d(_Conv):
    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, group)
        self.weight = _sliced(layer.weight, axis, index, extent)


class ColumnParallelWNConv1d(_Conv):
    """`WNConv1d` over the rank's output channels: v and g sliced on axis 0,
    so the norm (over in and k) stays on the rank."""

    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, group)
        self.v, self.g = _sliced(layer.v, 0, index, extent), _sliced(layer.g, 0, index, extent)

    kernel = _WeightNormed.weight


class _ConvTranspose(_ColumnParallel):
    def __init__(self, layer, group):
        super().__init__(layer, group)
        self.stride, self.padding = layer.stride, layer.padding

    def local(self, x, w):
        return conv_transpose1d(x, w, None, self.stride, self.padding)


class ColumnParallelConvTranspose1d(_ConvTranspose):
    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, group)
        self.weight = _sliced(layer.weight, axis, index, extent)


class ColumnParallelWNConvTranspose1d(_ConvTranspose):
    """`WNConvTranspose1d` over the rank's output channels: v [in, out/m, k]
    sliced on axis 1, g [in, 1, 1] whole. The norm per input channel runs
    over (out, k), so the ranks' partial sums of squares are all-reduced."""

    def __init__(self, layer, axis, index, extent, group):
        super().__init__(layer, group)
        self.v, self.g = _sliced(layer.v, 1, index, extent), layer.g

    def kernel(self):
        ss = all_reduce_sum(torch.sum(self.v * self.v, dim=(1, 2), keepdim=True), self.group)
        return copy_to_group(self.g, self.group) * self.v / torch.sqrt(ss)


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
    model._parameters["text_embedding"] = _sliced(model.text_embedding, 1, index, extent)
    model.embed = lambda text: gather_columns(F.embedding(text, model.text_embedding), group, dim=-1)
