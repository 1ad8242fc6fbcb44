"""Products, convolutions and normalizations of the reference, at its precision."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, kept as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding in the forward, the gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class Ops:
    """The reference's arithmetic. `tf32=False`: f32, cuBLAS and cuDNN with
    TF32 off. `tf32=True` (the control): TF32 products and convolutions."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextlib.contextmanager
    def precision(self, device):
        """Hold cuBLAS and cuDNN at this precision, restoring the flags after."""
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        on = self.tf32 and torch.device(device).type == "cuda"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def _r(self, x):
        """An operand as the control's emulation rounds it (on the CPU only)."""
        if self.tf32 and x.device.type == "cpu":
            return _RoundTF32.apply(x)
        return x

    def linear(self, x, p):
        """x [..., in] @ w [in, out] + b."""
        return torch.matmul(self._r(x), self._r(p["w"])) + p["b"]

    def conv(self, x, p, dilation: int = 1, key: str = "w"):
        """'SAME' conv on channels-last x [B, T, Cin]; w [k, Cin, Cout]."""
        w = p[key]
        k = w.shape[0]
        y = F.conv1d(self._r(x).transpose(1, 2), self._r(w).permute(2, 1, 0), padding=(k - 1) // 2 * dilation,
                     dilation=dilation)
        return y.transpose(1, 2) + p["b"]

    def conv_transpose(self, x, p, stride: int):
        """PyTorch's ConvTranspose1d, padding (k - stride) // 2; w [k, Cin, Cout]."""
        w = p["w"]
        k = w.shape[0]
        y = F.conv_transpose1d(self._r(x).transpose(1, 2), self._r(w).permute(1, 2, 0), stride=stride,
                               padding=(k - stride) // 2)
        return y.transpose(1, 2) + p["b"]

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._r(a), self._r(b))


def leaky(x, slope: float):
    return torch.where(x >= 0, x, x * slope)


def layer_norm(x, p, eps: float = 1e-12):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def masked_softmax(scores, mask, dim: int):
    """softmax over `dim` of the entries where `mask` is True (each slice
    along `dim` holds one at least); the others get 0."""
    return torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=dim)


def length_mask(lengths, t: int):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def positional_table(t: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table [t, d]: sin at even channels, cos at odd ones."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    freq = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    table = np.zeros((t, d))
    table[:, 0::2] = np.sin(pos * freq)
    table[:, 1::2] = np.cos(pos * freq)
    return torch.from_numpy(table).float().to(device)
