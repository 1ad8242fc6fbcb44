"""NN primitives on channels-last [B, T, C] activations.

Counterpart of `efficient_tts_tpu/nn/layers.py`. Weights use PyTorch's
layouts ([out, in] linear, [out, in, k] conv, [in, out, k] transposed
conv); `compat.py` converts the JAX package's [in, out] / WIO layouts.
Rounding follows the JAX functions: a layer computes its product in the
activation dtype (f32 accumulation for bf16), rounds, then adds the bias
cast to that dtype.

Parameters are built frozen (`requires_grad=False`); the weight bridge
makes a model trainable on request (`compat.py`, `trainable=True`).
`WNConv1d` keeps weight norm trainable, as {v, g}, folded into the conv
weight on each forward; `fold` gives the plain `Conv1d` of inference.
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


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None, deterministic: bool) -> torch.Tensor:
    """Keep each element with probability 1 - rate and scale it by 1 / (1 -
    rate), else 0 (`efficient_tts_tpu/nn/layers.py:dropout`). The mask is
    drawn on x's device from a generator seeded by one draw of `gen`."""
    if deterministic or rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout needs a generator when it is not deterministic")
    keep = 1.0 - rate
    dev_gen = torch.Generator(device=x.device).manual_seed(_seeds(gen, 1)[0])
    mask = torch.rand(x.shape, generator=dev_gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T + b."""
    return F.linear(x, w.to(x.dtype)) + b.to(x.dtype)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """[B, T, Cin] -> [B, T, Cout]; w [Cout, Cin, k]. 'SAME' padding for odd
    k: (k-1)//2 * dilation on both sides."""
    padding = (w.shape[-1] - 1) // 2 * dilation
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, padding=padding, dilation=dilation)
    return y.transpose(1, 2) + b.to(x.dtype)


def conv_transpose1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int
) -> torch.Tensor:
    """[B, T, Cin] -> [B, (T-1)*stride - 2*padding + k, Cout]; w [Cin, Cout, k]
    (torch ConvTranspose1d semantics)."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride, padding=padding)
    return y.transpose(1, 2) + b.to(x.dtype)


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


class WNConv1d(nn.Module):
    """A weight-normed conv: v [out, in, k], g [out, 1, 1] and the bias; the
    forward convolves with w = g * v / ||v||, the norm over the axes where g
    has size 1 (in and k), eps 0 (`efficient_tts_tpu/nn/layers.py:
    weight_norm_kernel`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.v = frozen_param((out_ch, in_ch, kernel_size))
        self.g = frozen_param((out_ch, 1, 1))
        self.bias = frozen_param((out_ch,))
        self.dilation = dilation

    def weight(self) -> torch.Tensor:
        axes = tuple(i for i in range(self.v.dim()) if self.g.shape[i] == 1)
        return self.g * self.v / torch.sqrt(torch.sum(self.v * self.v, dim=axes, keepdim=True))

    def forward(self, x):
        return conv1d(x, self.weight(), self.bias, self.dilation)

    @torch.no_grad()
    def fold(self) -> Conv1d:
        """The plain conv of the same weights, folded as `fold_weight_norm`
        folds the JAX tree (f64 on the host), so a folded model equals one
        loaded folded bit for bit."""
        out_ch, in_ch, k = self.v.shape
        conv = Conv1d(in_ch, out_ch, k, self.dilation).to(self.v.device)
        w = weight_norm_kernel(self.v.cpu().numpy(), self.g.cpu().numpy())
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(self.bias)
        return conv


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
