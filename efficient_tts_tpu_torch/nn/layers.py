"""NN primitives on channels-last [B, T, C] activations.

Counterpart of `efficient_tts_tpu/nn/layers.py`. Weights use PyTorch's
layouts ([out, in] linear, [out, in, k] conv, [in, out, k] transposed
conv); `compat.py` converts the JAX package's [in, out] / WIO layouts.
Rounding follows the JAX functions: a layer computes its product in the
activation dtype (f32 accumulation for bf16), rounds, then adds the bias
cast to that dtype.

Parameters are built frozen (`requires_grad=False`); the weight bridge
makes a model trainable on request (`compat.py`, `trainable=True`).
`WNConv1d`, `WNConvTranspose1d` and `WNConv2d` keep weight norm trainable,
as {v, g}, folded into the weight on each forward: g keeps the preserved
axis (the output channels of a conv, the input channels of a transposed
conv) and size 1 elsewhere, as the JAX package's `weight_norm_init` keepdims
shapes do, and the norm runs over the axes of size 1. `fold` gives the plain
layer of inference. `SNConv1d` is the spectral-normed conv of HiFi-GAN's
first scale discriminator: `w_orig` trainable, the power iteration's `u` and
`v` buffers advanced by an explicit `power_iteration` call, not by the
forward. Activations are channels-last for every layer: [B, T, C], and
[B, H, W, C] for the 2-D conv.
Dropout takes an explicit generator, as JAX's takes a key: a CPU
`torch.Generator` is the host-side key, `split_generator` its
`jax.random.split`, and each dropout call seeds a generator on the
activation's device from one draw of it, so no mask crosses the bus and no
draw waits for the device. The two frameworks' streams differ, so the
masks do too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def frozen_param(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def _seeds(gen: torch.Generator, n: int) -> list[int]:
    if gen.device.type != "cpu":
        raise ValueError("dropout keys are CPU generators (host-side, like a JAX key)")
    return torch.randint(0, 2**62, (n,), generator=gen).tolist()


def split_generator(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """n independent CPU generators seeded from draws of `gen`."""
    return [torch.Generator().manual_seed(s) for s in _seeds(gen, n)]


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None, deterministic: bool,
            window: tuple[int, int] | None = None, axis: int = 1) -> torch.Tensor:
    """Keep each element with probability 1 - rate and scale it by 1 / (1 -
    rate), else 0 (`efficient_tts_tpu/nn/layers.py:dropout`). The mask is
    drawn on x's device from a generator seeded by one draw of `gen`. With
    `window=(length, start)` x is entries start.. of a sequence of `length`
    along `axis` (the frames, axis 1, by default), and takes those entries
    of the whole sequence's mask."""
    if deterministic or rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout needs a generator when it is not deterministic")
    keep = 1.0 - rate
    dev_gen = torch.Generator(device=x.device).manual_seed(_seeds(gen, 1)[0])
    if window is None:
        mask = torch.rand(x.shape, generator=dev_gen, device=x.device) < keep
    else:
        length, start = window
        shape = list(x.shape)
        shape[axis] = length
        whole = torch.rand(shape, generator=dev_gen, device=x.device)
        mask = whole.narrow(axis, start, x.shape[axis]) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _plus_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T + b (b None: no bias)."""
    return _plus_bias(F.linear(x, w.to(x.dtype)), b)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, dilation: int = 1, stride: int = 1,
           padding: int | None = None, groups: int = 1) -> torch.Tensor:
    """[B, T, Cin] -> [B, T', Cout]; w [Cout, Cin / groups, k]. `padding`
    None is 'SAME' for odd k: (k-1)//2 * dilation on both sides."""
    if padding is None:
        padding = (w.shape[-1] - 1) // 2 * dilation
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    return _plus_bias(y.transpose(1, 2), b)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """[B, H, W, Cin] -> [B, H', W', Cout]; w [Cout, Cin, kh, kw], symmetric
    padding (`efficient_tts_tpu/nn/layers.py:conv2d`, NHWC)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride=tuple(stride), padding=tuple(padding))
    return y.permute(0, 2, 3, 1) + b.to(x.dtype)


def avg_pool1d(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """torch AvgPool1d with count_include_pad=True on [B, T, C]: the window's
    sum over `window`, zero padding counted (`nn/layers.py:avg_pool1d`)."""
    y = F.avg_pool1d(x.transpose(1, 2), window, stride, padding, count_include_pad=True)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int, padding: int
) -> torch.Tensor:
    """[B, T, Cin] -> [B, (T-1)*stride - 2*padding + k, Cout]; w [Cin, Cout, k]
    (torch ConvTranspose1d semantics)."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride, padding=padding)
    return _plus_bias(y.transpose(1, 2), b)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the channel axis; eps 1e-12 as in the JAX package
    (torch's default 1e-5 would differ)."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """where(x >= 0, x, slope * x) with the slope rounded to x's dtype first,
    as JAX does with a Python scalar (bf16(0.1) = 0.10009765625)."""
    slope = torch.tensor(negative_slope, dtype=x.dtype).item()
    return torch.where(x >= 0, x, x * slope)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = frozen_param((out_dim, in_dim))
        self.bias = frozen_param((out_dim,))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.weight = frozen_param((out_ch, in_ch, kernel_size))
        self.bias = frozen_param((out_ch,))
        self.dilation = dilation

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.dilation)


class _WeightNormed(nn.Module):
    """v, g and the bias of a weight-normed layer; `weight()` is g * v / ||v||,
    the norm over the axes where g has size 1, eps 0, in JAX's order
    (`efficient_tts_tpu/nn/layers.py:weight_norm_kernel`)."""

    def __init__(self, v_shape, g_shape, out_ch: int):
        super().__init__()
        self.v = frozen_param(v_shape)
        self.g = frozen_param(g_shape)
        self.bias = frozen_param((out_ch,))

    def weight(self) -> torch.Tensor:
        axes = tuple(i for i in range(self.v.dim()) if self.g.shape[i] == 1)
        return self.g * self.v / torch.sqrt(torch.sum(self.v * self.v, dim=axes, keepdim=True))

    @torch.no_grad()
    def _folded(self, plain: nn.Module) -> nn.Module:
        """`plain` with this layer's weights, folded as `fold_weight_norm` folds
        the JAX tree (f64 on the host), so a folded model equals one loaded
        folded bit for bit."""
        plain = plain.to(self.v.device)
        plain.weight.copy_(torch.from_numpy(weight_norm_kernel(self.v.cpu().numpy(), self.g.cpu().numpy())))
        plain.bias.copy_(self.bias)
        return plain


class WNConv1d(_WeightNormed):
    """A weight-normed conv: v [out, in / groups, k], g [out, 1, 1] and the
    bias; `padding` None is 'SAME'."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1, stride: int = 1,
                 groups: int = 1, padding: int | None = None):
        super().__init__((out_ch, in_ch // groups, kernel_size), (out_ch, 1, 1), out_ch)
        self.dilation, self.stride, self.groups, self.padding = dilation, stride, groups, padding

    def forward(self, x):
        return conv1d(x, self.weight(), self.bias, self.dilation, self.stride, self.padding, self.groups)

    def fold(self) -> Conv1d:
        if (self.stride, self.groups, self.padding) != (1, 1, None):
            raise ValueError("only a 'SAME', stride-1, ungrouped conv folds into a Conv1d")
        out_ch, in_ch, k = self.v.shape
        return self._folded(Conv1d(in_ch, out_ch, k, self.dilation))


class WNConvTranspose1d(_WeightNormed):
    """A weight-normed transposed conv: v [in, out, k] and g [in, 1, 1], the
    norm per *input* channel as torch's `weight_norm(dim=0)` takes it for a
    ConvTranspose1d (`efficient_tts_tpu/models/hifigan.py:101`,
    `preserved_axis=1` in the WIO layout)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int):
        super().__init__((in_ch, out_ch, kernel_size), (in_ch, 1, 1), out_ch)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv_transpose1d(x, self.weight(), self.bias, self.stride, self.padding)

    def fold(self) -> "ConvTranspose1d":
        in_ch, out_ch, k = self.v.shape
        return self._folded(ConvTranspose1d(in_ch, out_ch, k, self.stride, self.padding))


class WNConv2d(_WeightNormed):
    """A weight-normed 2-D conv on [B, H, W, C]: v [out, in, kh, kw] and g
    [out, 1, 1, 1] (the JAX package's HWIO with g [1, 1, 1, out])."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0)):
        super().__init__((out_ch, in_ch, *kernel_size), (out_ch, 1, 1, 1), out_ch)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x):
        return conv2d(x, self.weight(), self.bias, self.stride, self.padding)


class SNConv1d(nn.Module):
    """A spectral-normed conv (`efficient_tts_tpu/models/hifigan.py:764-822`):
    w_orig [out, in / groups, k] trainable, the bias, and the buffers u [out]
    and v [k * in / groups]. The forward convolves with w_orig / sigma, sigma =
    u . (W v) for the [out, k * in / groups] matrix W of `matrix()` (the JAX
    package's `_sn_matrix` column order, tap-major), u and v held constant: the
    gradient reaches w_orig through the numerator and sigma alike.
    `power_iteration` advances u and v once, outside autograd; torch's
    `spectral_norm` would advance them on every training forward instead."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, groups: int = 1,
                 padding: int = 0):
        super().__init__()
        self.w_orig = frozen_param((out_ch, in_ch // groups, kernel_size))
        self.bias = frozen_param((out_ch,))
        self.register_buffer("u", torch.zeros(out_ch))
        self.register_buffer("v", torch.zeros(kernel_size * (in_ch // groups)))
        self.stride, self.groups, self.padding = stride, groups, padding

    def matrix(self) -> torch.Tensor:
        return self.w_orig.permute(0, 2, 1).reshape(self.w_orig.shape[0], -1)

    def sigma(self) -> torch.Tensor:
        return torch.dot(self.u, self.matrix() @ self.v)

    def weight(self) -> torch.Tensor:
        return self.w_orig / self.sigma()

    @torch.no_grad()
    def power_iteration(self, eps: float = 1e-12) -> None:
        """One torch-style iteration, v then u (`spectral_power_iteration`)."""
        w = self.matrix()
        v = w.T @ self.u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
        u = w @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
        self.u.copy_(u)
        self.v.copy_(v)

    def forward(self, x):
        return conv1d(x, self.weight(), self.bias, 1, self.stride, self.padding, self.groups)


class ConvTranspose1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.weight = frozen_param((in_ch, out_ch, kernel_size))
        self.bias = frozen_param((out_ch,))
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = frozen_param((dim,))
        self.bias = frozen_param((dim,))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)


# ---------------------------------------------------------------------------
# weight norm on the JAX package's numpy parameter trees


def weight_norm_kernel(v: np.ndarray, g: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """w = g * v / ||v||, reducing over the axes where g has size 1 (the
    input axis of a transposed conv, every axis but the output elsewhere)."""
    v = np.asarray(v, np.float64)
    g = np.asarray(g, np.float64)
    axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True) + eps)
    return (g * v / norm).astype(np.float32)


def fold_weight_norm(params):
    """Recursively collapse every {v, g, b} into {w, b}; {w, b} passes."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            return {"w": weight_norm_kernel(params["v"], params["g"]),
                    "b": np.asarray(params["b"], np.float32)}
        return {k: fold_weight_norm(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [fold_weight_norm(v) for v in params]
    return np.asarray(params, np.float32)
