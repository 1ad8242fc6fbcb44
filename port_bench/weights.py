"""Seeded weights, made on the device in a few large draws.

A model's weights are a tree of nested dicts and lists in the JAX package's
layout (linear [in, out], conv [k, in, out], transposed conv [k, in, out],
weight norm {v, g, b} with g = ||v|| over every axis but the output), the
layout that the port's loading API (`compat.*_from_jax`) takes. `make_tree`
draws every leaf of a spec from two buffers, one uniform and one normal,
drawn on the device by one `torch.Generator` each, so the seed alone fixes
the weights. The same device tensors go to the reference; the port gets
them through `to_numpy` and its loader.

Distributions: PyTorch's default for convs and linears (uniform of bound
1 / sqrt(fan_in), weights and biases), N(0, 1) embeddings, LayerNorm scale 1
and bias 0, and HiFi-GAN's own N(0, 0.01) for the generator's upsamples and
MRF convs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Leaf:
    path: tuple
    shape: tuple
    init: str  # "uniform" (bound 1 / sqrt(fan)), "normal" (std `scale`), "ones", "zeros", "const", "wn_g"
    fan: int = 1
    scale: float = 1.0


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (a generator, a stream of
    sentences), from numpy's SeedSequence: any non-negative `seed` works."""
    words = [int(seed)] + [int.from_bytes(str(t).encode(), "little") % (1 << 32) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def _linear(path, din, dout):
    return [Leaf(path + ("w",), (din, dout), "uniform", din), Leaf(path + ("b",), (dout,), "uniform", din)]


def _conv(path, cin, cout, k, weight_norm=False, init="uniform", fan=None):
    fan = fan or cin * k
    leaves = [Leaf(path + ("v" if weight_norm else "w",), (k, cin, cout), init, fan, 0.01)]
    if weight_norm:
        leaves.append(Leaf(path + ("g",), (1, 1, cout), "wn_g"))
    return leaves + [Leaf(path + ("b",), (cout,), "uniform", fan)]


def _norm(path, c):
    return [Leaf(path + ("scale",), (c,), "ones"), Leaf(path + ("bias",), (c,), "zeros")]


def _duration_predictor(c, n_layers, pin=None):
    leaves = []
    for i in range(n_layers):
        leaves += _conv(("duration_predictor", "convs", i), c, c, 3)
        leaves += _norm(("duration_predictor", "norms", i), c)
    if pin is None:
        return leaves + _linear(("duration_predictor", "out"), c, 1)
    # the pinned head: w = 0, b = log(frames a symbol + the duration offset)
    return leaves + [Leaf(("duration_predictor", "out", "w"), (c, 1), "zeros"),
                     Leaf(("duration_predictor", "out", "b"), (1,), "const", scale=pin)]


def efts_cnn_spec(p: dict, training: bool, pin=None) -> list:
    """EFTS-CNN (`model_params` of its config): the training modules and
    weight norm with `training`, else the inference model's plain convs."""
    c, k = p["n_channels"], p["k_size"]
    wn = training and p.get("use_weight_norm", True)
    leaves = [Leaf(("text_embedding", "table"), (p["num_symbols"], p["symbol_embedding_dim"]), "normal")]

    def block(name, n):
        return [leaf for i in range(n) for leaf in _conv((name, "layers", i), c, c, k, weight_norm=wn)]

    leaves += block("text_encoder", p["n_text_encoder_layer"])
    leaves += _linear(("text_value",), c, c)
    if training:
        leaves += _linear(("text_key",), c, c) + _linear(("mel_prenet",), p["odim"], c)
        leaves += block("mel_encoder", p["n_mel_encoder_layer"])
    leaves += block("decoder", p["n_decoder_layer"])
    leaves += _linear(("mel_out",), c, p["odim"])
    return leaves + _duration_predictor(c, p["n_duration_layer"], pin)


def efts_transformer_spec(p: dict, training: bool) -> list:
    """EFTS-Transformer (`model_params`), with the training modules when `training`."""
    c, hidden, k = p["n_channels"], p["ff_hidden"], p["kernel_size"]

    def block(name, n):
        leaves = []
        for i in range(n):
            lp = (name, "layers", i)
            for m in ("q", "k", "v", "out"):
                leaves += _linear(lp + ("self_attn", m), c, c)
            leaves += _conv(lp + ("ff", "conv1"), c, hidden, k) + _conv(lp + ("ff", "conv2"), hidden, c, k)
            leaves += _norm(lp + ("norm1",), c) + _norm(lp + ("norm2",), c)
        return leaves + _norm((name, "final_norm"), c)

    leaves = [Leaf(("text_embedding", "table"), (p["num_symbols"], c), "normal"), Leaf(("pe_scale",), (), "ones")]
    leaves += block("text_encoder", p["n_text_encoder_layer"]) + _linear(("text_value",), c, c)
    if training:
        leaves += _linear(("text_key",), c, c) + _linear(("mel_prenet",), p["odim"], c)
        leaves += block("mel_encoder", p["n_mel_encoder_layer"])
    leaves += block("decoder", p["n_decoder_layer"]) + _linear(("mel_out",), c, p["odim"])
    return leaves + _duration_predictor(c, p["n_duration_layer"])


def hifigan_spec(v: dict) -> list:
    """The HiFi-GAN generator (`vocoder_params`), plain convs (inference)."""
    c0 = v["upsample_initial_channel"]
    leaves = _conv(("conv_pre",), v["num_mels"], c0, 7)
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        cin, cout = c0 // 2**i, c0 // 2 ** (i + 1)
        leaves += _conv(("ups", i), cin, cout, k, init="normal", fan=cout * k)
    names = ("convs1", "convs2") if v["resblock"] == "1" else ("convs",)
    n = 0
    for i in range(len(v["upsample_rates"])):
        ch = c0 // 2 ** (i + 1)
        for k, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            for name in names:
                for j in range(len(dils)):
                    leaves += _conv(("resblocks", n, name, j), ch, ch, k, init="normal")
            n += 1
    return leaves + _conv(("conv_post",), c0 // 2 ** len(v["upsample_rates"]), 1, 7)


def _put(tree, path, value):
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(tree, list):
            while len(tree) <= key:
                tree.append([] if isinstance(nxt, int) else {})
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(tree, list):
        while len(tree) <= path[-1]:
            tree.append(None)
    tree[path[-1]] = value


def make_tree(spec: list, seed: int, device) -> dict:
    """The tree of `spec` as f32 tensors on `device`, from `seed`: one
    uniform draw for every "uniform" leaf and one normal draw for every
    "normal" leaf, each sliced into the leaves in spec order."""
    gen = torch.Generator(device=device)
    sizes = {kind: sum(math.prod(leaf.shape) for leaf in spec if leaf.init == kind) for kind in ("uniform", "normal")}
    gen.manual_seed(sub_seed(seed, "uniform"))
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    gen.manual_seed(sub_seed(seed, "normal"))
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    offsets = {"uniform": 0, "normal": 0}
    tree: dict = {}
    last_v = None
    for leaf in spec:
        n = math.prod(leaf.shape)
        if leaf.init in offsets:
            o = offsets[leaf.init]
            offsets[leaf.init] = o + n
            raw = (uniform if leaf.init == "uniform" else normal)[o:o + n].view(leaf.shape)
            if leaf.init == "uniform":
                bound = 1.0 / math.sqrt(leaf.fan)
                value = raw.mul(2.0 * bound).sub_(bound)
            else:
                value = raw * leaf.scale
        elif leaf.init == "wn_g":
            value = torch.sqrt(torch.sum(last_v * last_v, dim=(0, 1), keepdim=True))
        elif leaf.init == "const":
            value = torch.full(leaf.shape, leaf.scale, device=device)
        else:
            value = (torch.ones if leaf.init == "ones" else torch.zeros)(leaf.shape, device=device)
        last_v = value
        _put(tree, leaf.path, value)
    return tree


def to_numpy(tree):
    """The tree with numpy leaves, for the port's loaders (one copy to the host each)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def port_name(path: tuple) -> str:
    """The port's parameter name of a tree path: keys joined by dots, "w" as
    "weight", "b" as "bias", an embedding's "table" dropped."""
    last = {"w": "weight", "b": "bias", "table": None}.get(path[-1], path[-1])
    return ".".join(str(k) for k in (*path[:-1], *([last] if last else [])))


def port_layout(path: tuple, t: torch.Tensor) -> torch.Tensor:
    """A training model's leaf in the port's layout: a linear's [in, out] as
    [out, in], a conv's [k, in, out] (and weight norm's g) as [out, in, k];
    embeddings, vectors and scalars as they are."""
    if t.dim() == 3:
        return t.permute(2, 1, 0)
    if t.dim() == 2 and path[-1] != "table":
        return t.T
    return t
