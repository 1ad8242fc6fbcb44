"""Seeded BigVGAN generator weights in the published state-dict layout, made on the device.

The keys and shapes of NVIDIA/BigVGAN's generator state dict: `conv_pre`,
`ups.{i}.0`, `resblocks.{n}.convs1.{j}` / `.convs2.{j}`,
`resblocks.{n}.activations.{m}` (`.act.alpha`, `.act.beta`,
`.upsample.filter`, `.downsample.lowpass.filter`), `activation_post` and
`conv_post`, weight-normed as the published checkpoints hold them: each
conv's `.weight_v` drawn and `.weight_g` = ||v|| over every axis but the
first, as `weight_norm` sets it. The same device tensors go to the
reference; the port gets them through its loader
(`compat.bigvgan_generator_from_state_dict`).

Distributions: `conv_pre` PyTorch's default (uniform of bound 1 /
sqrt(fan_in), weight and bias); the upsamples' and AMP blocks' weights
N(0, 0.01) as BigVGAN's `init_weights` draws them, their biases PyTorch's
default; SnakeBeta's log-scale alpha and beta U(-1, 1) per channel (the
published init is 0, which would make every channel alike); the filters
the published Kaiser-windowed sinc. One uniform and one normal draw on the
device, each sliced into the leaves in key order, as `weights.make_tree`
does.
"""

from __future__ import annotations

import math

import torch

from port_bench import weights
from port_bench.reference.bigvgan import kaiser_sinc_filter1d


def bigvgan_spec(v: dict) -> list:
    """(key, shape, init, fan) of every tensor: init "uniform" (bound 1 /
    sqrt(fan)), "normal" (std 0.01), "wn_g" (||v|| of the key before it) or
    "filter"."""
    def conv(prefix, shape, cout, init, fan, bias=True):
        # fan: PyTorch's fan_in, in * k (a transposed conv's [in, out, k]: out * k)
        out = [(prefix + ".weight_v", shape, init, fan), (prefix + ".weight_g", (shape[0], 1, 1), "wn_g", 1)]
        return out + ([(prefix + ".bias", (cout,), "uniform", fan)] if bias else [])

    def act(prefix, c):
        return [(prefix + ".act.alpha", (c,), "uniform", 1), (prefix + ".act.beta", (c,), "uniform", 1),
                (prefix + ".upsample.filter", (1, 1, 12), "filter", 1),
                (prefix + ".downsample.lowpass.filter", (1, 1, 12), "filter", 1)]

    c0, mels = v["upsample_initial_channel"], v["num_mels"]
    spec = conv("conv_pre", (c0, mels, 7), c0, "uniform", mels * 7)
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        cin, cout = c0 // 2**i, c0 // 2 ** (i + 1)
        spec += conv(f"ups.{i}.0", (cin, cout, k), cout, "normal", cout * k)
    n = 0
    for i in range(len(v["upsample_rates"])):
        ch = c0 // 2 ** (i + 1)
        for k, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            for name in ("convs1", "convs2"):
                for j in range(len(dils)):
                    spec += conv(f"resblocks.{n}.{name}.{j}", (ch, ch, k), ch, "normal", ch * k)
            for m in range(2 * len(dils)):
                spec += act(f"resblocks.{n}.activations.{m}", ch)
            n += 1
    c_last = c0 // 2 ** len(v["upsample_rates"])
    spec += act("activation_post", c_last)
    return spec + conv("conv_post", (1, c_last, 7), 1, "normal", c_last * 7, bias=v["use_bias_at_final"])


def make_state_dict(v: dict, seed: int, device) -> dict:
    """The state dict of `bigvgan_spec(v)` as f32 tensors on `device`, from `seed`."""
    spec = bigvgan_spec(v)
    gen = torch.Generator(device=device)
    sizes = {kind: sum(math.prod(s) for _, s, init, _ in spec if init == kind) for kind in ("uniform", "normal")}
    gen.manual_seed(weights.sub_seed(seed, "uniform"))
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    gen.manual_seed(weights.sub_seed(seed, "normal"))
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    h = kaiser_sinc_filter1d().to(device)
    offsets = {"uniform": 0, "normal": 0}
    sd, last_v = {}, None
    for key, shape, init, fan in spec:
        n = math.prod(shape)
        if init in offsets:
            o = offsets[init]
            offsets[init] = o + n
            raw = (uniform if init == "uniform" else normal)[o:o + n].view(shape)
            bound = 1.0 / math.sqrt(fan)
            value = raw.mul(2.0 * bound).sub_(bound) if init == "uniform" else raw * 0.01
        elif init == "wn_g":
            value = torch.sqrt(torch.sum(last_v * last_v, dim=(1, 2), keepdim=True))
        else:
            value = h.clone()
        last_v = value
        sd[key] = value
    return sd
