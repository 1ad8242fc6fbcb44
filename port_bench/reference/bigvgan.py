"""BigVGAN's generator (AMPBlock1, anti-aliased SnakeBeta), mel -> waveform.

The equations of NVIDIA/BigVGAN's `bigvgan.py` (v2) and its
`alias_free_activation/torch/` at inference, channels-first [B, C, T], f32:
conv_pre (k 7); per stage a transposed conv (padding (k - u) // 2), then
the mean of one AMP block per kernel size, each block per dilation d
x + c2(A2(c1_d(A1(x)))); then A_post, conv_post (k 7, its bias only when
the state dict has one) and tanh or a clamp to [-1, 1]. Each A upsamples
2x (replicate-pad 5, 2 * depthwise conv_transpose1d with the 12-tap
filter at stride 2, keep [15, -15)), applies SnakeBeta x + (1 / (beta +
1e-9)) * sin(alpha x)^2 (alpha and beta exp'd under `snake_logscale`) and
downsamples 2x (replicate-pad 5 left and 6 right, depthwise conv1d with
the filter at stride 2).

It reads the published generator state dict as it is: weight norm as
`.weight_g` / `.weight_v` or a folded `.weight`, the filters the state
dict's own `.upsample.filter` and `.downsample.lowpass.filter` buffers.
Departures from the published code: weight norm is folded at each call in
f64 and rounded to f32 (the published forward folds in f32), so a folded
weight may differ from the published one in its last bit; the optional
fused CUDA activation (`use_cuda_kernel`) is not modelled, its torch path
is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.ops import Ops


def kaiser_sinc_filter1d(cutoff: float = 0.25, half_width: float = 0.3, kernel_size: int = 12) -> torch.Tensor:
    """`alias_free_activation/torch/filter.py:kaiser_sinc_filter1d` for an
    even kernel: the [1, 1, kernel_size] filter of the 2x resamplers."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (h / h.sum()).view(1, 1, kernel_size)


def _weight(sd: dict, prefix: str) -> torch.Tensor:
    """A layer's weight: g * v / ||v||, the norm over every axis but the first
    (torch's weight_norm(dim=0)), or the folded weight."""
    if prefix + ".weight" in sd:
        return sd[prefix + ".weight"]
    v, g = sd[prefix + ".weight_v"].double(), sd[prefix + ".weight_g"].double()
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return (g * v / norm).float()


def _conv(x, sd: dict, prefix: str, ops: Ops, dilation: int = 1):
    w = _weight(sd, prefix)
    k = w.shape[-1]
    return F.conv1d(ops._r(x), ops._r(w), sd.get(prefix + ".bias"), padding=dilation * (k - 1) // 2,
                    dilation=dilation)


def activation(x, sd: dict, prefix: str, logscale: bool, ops: Ops):
    """`Activation1d(SnakeBeta)` of the state dict's entries under `prefix`: [B, C, T] -> [B, C, T]."""
    c = x.shape[1]
    up = sd[prefix + ".upsample.filter"].expand(c, -1, -1)
    down = sd[prefix + ".downsample.lowpass.filter"].expand(c, -1, -1)
    y = 2 * F.conv_transpose1d(ops._r(F.pad(x, (5, 5), mode="replicate")), ops._r(up), stride=2, groups=c)
    y = y[..., 15:-15]
    alpha = sd[prefix + ".act.alpha"][None, :, None]
    beta = sd[prefix + ".act.beta"][None, :, None]
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    y = y + (1.0 / (beta + 1e-9)) * torch.pow(torch.sin(y * alpha), 2)
    return F.conv1d(ops._r(F.pad(y, (5, 6), mode="replicate")), ops._r(down), stride=2, groups=c)


def generator(sd: dict, v: dict, mel: torch.Tensor, ops: Ops) -> torch.Tensor:
    """[B, T, num_mels] -> [B, T * prod(upsample_rates)]; `v` the
    configuration's `vocoder_params`."""
    if v["resblock"] != "1" or v["activation"] != "snakebeta":
        raise ValueError("the reference holds AMPBlock1 generators with snakebeta activations only")
    logscale = v["snake_logscale"]
    x = _conv(mel.transpose(1, 2), sd, "conv_pre", ops)
    n_k = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(ops._r(x), ops._r(_weight(sd, f"ups.{i}.0")), sd[f"ups.{i}.0.bias"], stride=u,
                               padding=(k - u) // 2)
        xs = None
        for j, dils in enumerate(v["resblock_dilation_sizes"]):
            p = f"resblocks.{i * n_k + j}"
            xb = x
            for n, d in enumerate(dils):
                xt = activation(xb, sd, f"{p}.activations.{2 * n}", logscale, ops)
                xt = _conv(xt, sd, f"{p}.convs1.{n}", ops, d)
                xt = activation(xt, sd, f"{p}.activations.{2 * n + 1}", logscale, ops)
                xb = _conv(xt, sd, f"{p}.convs2.{n}", ops) + xb
            xs = xb if xs is None else xs + xb
        x = xs / n_k
    x = _conv(activation(x, sd, "activation_post", logscale, ops), sd, "conv_post", ops)
    x = torch.tanh(x) if v["use_tanh_at_final"] else torch.clamp(x, -1.0, 1.0)
    return x[:, 0]
