"""Whole-model re-initialization (counterpart of `efficient_tts_tpu/nn/init.py`).

`initialize(model, init_type, gen)` re-draws, in place, exactly the leaves
that the JAX function re-draws: every parameter of rank >= 2 (kernels,
embedding tables, weight norm's v and g, spectral norm's w_orig), leaving
biases, norm scales and the other vectors as they are. Each leaf is drawn
with the fans of its shape in the JAX package's layout, where kernels are
WIO (`fan_in = prod(shape[:-1])`, `fan_out = shape[-1]`): the torch layouts
[out, in] (linear), [out, in, k] (conv), [in, out, k] (transposed conv)
and [out, in, kh, kw] (2-D conv) are mapped back to [in, out], [k, in,
out], [k, in, out] and [kh, kw, in, out]; a conv's weight-norm g [out, 1,
1] is JAX's [1, 1, out] and a transposed conv's [in, 1, 1] is JAX's [1, in,
1]; an embedding table [V, C] keeps its meaning. The draws come from the
CPU generator `gen`, so the numbers differ from JAX's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import (Conv1d, ConvTranspose1d, Linear, SNConv1d, WNConv1d, WNConv2d,
                                               WNConvTranspose1d)
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device

INIT_TYPES = ("xavier_uniform", "xavier_normal", "kaiming_uniform", "kaiming_normal")


def _conv(s):  # [out, in, k] -> [k, in, out]
    return (s[2], s[1], s[0])


def _conv_t(s):  # [in, out, k] -> [k, in, out]
    return (s[2], s[0], s[1])


# (module type, parameter) -> the JAX shape of a torch shape
_JAX_SHAPES = {
    (Linear, "weight"): lambda s: (s[1], s[0]),
    (Conv1d, "weight"): _conv,
    (ConvTranspose1d, "weight"): _conv_t,
    (WNConv1d, "v"): _conv,
    (WNConv1d, "g"): _conv,
    (WNConvTranspose1d, "v"): _conv_t,
    (WNConvTranspose1d, "g"): lambda s: (1, s[0], 1),
    (WNConv2d, "v"): lambda s: (s[2], s[3], s[1], s[0]),
    (WNConv2d, "g"): lambda s: (1, 1, 1, s[0]),
    (SNConv1d, "w_orig"): _conv,
}


def jax_shapes(model: nn.Module) -> dict:
    """{name: JAX shape} of every parameter that `initialize` re-draws,
    named as `model.named_parameters()` names it."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.dim() < 2:
                continue
            full = f"{prefix}.{name}" if prefix else name
            rule = _JAX_SHAPES.get((type(mod), name))
            if rule is not None:
                out[full] = tuple(rule(tuple(p.shape)))
            elif name.endswith("embedding") and p.dim() == 2:
                out[full] = tuple(p.shape)
            else:
                raise ValueError(f"no JAX layout known for {full} of {type(mod).__name__} {tuple(p.shape)}")
    return out


def fans(jax_shape) -> tuple[int, int]:
    """(fan_in, fan_out) of a JAX-layout shape: [..., in, out]."""
    return int(math.prod(jax_shape[:-1])), int(jax_shape[-1])


def scale(init_type: str, jax_shape) -> float:
    """The uniform bound or the normal std that `init_type` gives a leaf."""
    fan_in, fan_out = fans(jax_shape)
    if init_type == "xavier_uniform":
        return math.sqrt(6.0 / (fan_in + fan_out))
    if init_type == "xavier_normal":
        return math.sqrt(2.0 / (fan_in + fan_out))
    if init_type == "kaiming_uniform":
        return math.sqrt(6.0 / fan_in)
    if init_type == "kaiming_normal":
        return math.sqrt(2.0 / fan_in)
    raise ValueError(f"unknown init_type: {init_type}")


@torch.no_grad()
def initialize(model: nn.Module, init_type: str, gen: torch.Generator, device="cuda") -> nn.Module:
    """Re-draw every rank >= 2 parameter of `model` in place: 'xavier_uniform'
    | 'xavier_normal' | 'kaiming_uniform' | 'kaiming_normal' (an unknown name
    raises before anything is drawn). `model` lies on `device` ("cuda" by
    default; without a card it raises unless the caller passes
    device="cpu"). Returns the model."""
    check_module_device(model, resolve_device(device))
    if init_type not in INIT_TYPES:
        raise ValueError(f"unknown init_type: {init_type}")
    params = dict(model.named_parameters())
    for name, shape in jax_shapes(model).items():
        p = params[name]
        s = scale(init_type, shape)
        if init_type.endswith("uniform"):
            new = torch.empty(p.shape).uniform_(-s, s, generator=gen)
        else:
            new = s * torch.randn(p.shape, generator=gen)
        p.copy_(new)
    return model
