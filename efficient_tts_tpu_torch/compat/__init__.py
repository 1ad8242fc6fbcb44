"""Weight bridge between the JAX package's parameter trees and the port's modules.

Takes the nested dicts of `efficient_tts_tpu` (`efts.init`, the
EFTS-Transformer's `init`, `hg.init_generator`, or their checkpoints)
holding numpy arrays, with each conv either weight-normed {v, g, b} or
plain {w, b}. Weight norm is folded
once here (eps 0). Layouts: linear [in, out] -> [out, in]; conv WIO
[k, in, out] -> [out, in, k]; transposed conv WIO -> [in, out, k]; MRF
stage convs -> the kernel's [k, out, in], each stage's 18 laid out once.
An inference model ignores the parameters that only the training forward
uses; `efts_cnn_from_jax` and `efts_transformer_from_jax` with
`trainable=True` load them too and make every parameter trainable (the
EFTS-CNN keeping weight norm unfolded, {v, g} of layout [out, in, k] and
[out, 1, 1]), and `efts_cnn_to_jax` / `efts_transformer_to_jax` map a
model's parameters (or their gradients) back onto the JAX tree's keys and
layouts, so the two can be compared leaf by leaf.

The vocoder's GAN state crosses the same way: `gan_state_from_jax` builds
the trainable generator (weight norm as {v, g}; a transposed conv's g on
its input axis, [in, 1, 1]), the period discriminators (HWIO <-> [out, in,
kh, 1]), the scale discriminators (grouped WIO [k, in / g, out] <-> [out,
in / g, k]; spectral norm as {w_orig, u, v, b}) and the EMA generator
from a JAX GAN state tree, with fresh optimizer states (the moments start
at zero on both sides: the bridge carries parameters only), and
`gan_state_to_jax` maps a port state, or gradients named as its
parameters, back onto the JAX tree. `generator_to_jax` is the generator's
half, on which `HiFiGANTrainGenerator.fold` rests.

The DurationModel crosses as its predictor's tree (with the speaker
table and projection when the config has them):
`duration_model_from_jax` / `duration_model_to_jax`; the postnet with its
batch-norm state {scale, bias, mean, var}: `postnet_from_jax` /
`postnet_to_jax`.

The reference's own PyTorch files (EFTS-CNN trainer checkpoints, HiFi-GAN
generator files, the official recipe's `g_` / `do_` pairs) are read by
`compat/torch_import.py` and written by `compat/torch_export.py`. The JAX
package has no BigVGAN: its published generator state dict is read by
`bigvgan_generator_from_state_dict`.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.models.bigvgan import BigVGANConfig, BigVGANGenerator
from efficient_tts_tpu_torch.models.duration_model import DurationModel, DurationModelConfig
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer, EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from efficient_tts_tpu_torch.models.hifigan_train import Discriminators, HiFiGANTrainGenerator
from efficient_tts_tpu_torch.nn.layers import SNConv1d, WNConv1d, fold_weight_norm
from efficient_tts_tpu_torch.nn.postnet import Postnet
from efficient_tts_tpu_torch.ops.alias_free import kaiser_sinc_filter
from efficient_tts_tpu_torch.utils.device import resolve_device


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
    param.data.copy_(value)


def _load_linear(mod, p):
    _set(mod.weight, p["w"].T)
    _set(mod.bias, p["b"])


def _load_conv(mod, p):
    _set(mod.weight, np.transpose(p["w"], (2, 1, 0)))
    _set(mod.bias, p["b"])


def _load_conv_transpose(mod, p):
    _set(mod.weight, np.transpose(p["w"], (1, 2, 0)))
    _set(mod.bias, p["b"])


def _load_norm(mod, p):
    _set(mod.scale, p["scale"])
    _set(mod.bias, p["bias"])


def _load_duration_predictor(mod, p):
    for conv, cp in zip(mod.convs, p["convs"], strict=True):
        _load_conv(conv, cp)
    for norm, npar in zip(mod.norms, p["norms"], strict=True):
        _load_norm(norm, npar)
    _load_linear(mod.out, p["out"])


# Trainable parameters as (path in the JAX tree, port parameter, layout),
# read one way by the loaders and the other way by `efts_*_to_jax`.
# Layouts: "linear" [in, out] <-> [out, in], "conv" [k, in, out] <-> [out,
# in, k] (both self-inverse transposes), "conv_transpose" [k, in, out] <->
# [in, out, k], "conv2d" HWIO <-> [out, in, kh, kw], "same" as it is.
_TO_PORT = {"linear": lambda a: a.T, "conv": lambda a: np.transpose(a, (2, 1, 0)),
            "conv_transpose": lambda a: np.transpose(a, (1, 2, 0)),
            "conv2d": lambda a: np.transpose(a, (3, 2, 0, 1)), "same": lambda a: a}
_TO_JAX = {**_TO_PORT, "conv_transpose": lambda a: np.transpose(a, (2, 0, 1)),
           "conv2d": lambda a: np.transpose(a, (2, 3, 1, 0))}


def _entries_linear(path, mod, layout="linear"):
    yield path + ("w",), mod.weight, layout
    yield path + ("b",), mod.bias, "same"


def _entries_norm(path, mod):
    yield path + ("scale",), mod.scale, "same"
    yield path + ("bias",), mod.bias, "same"


def _entries_block(path, block):
    for i, layer in enumerate(block.layers):
        lp = path + ("layers", i)
        for name in ("q", "k", "v", "out"):
            yield from _entries_linear(lp + ("self_attn", name), getattr(layer.self_attn, name))
        for name, mod in layer.ff.named_children():  # conv1/conv2 or w1/w2
            yield from _entries_linear(lp + ("ff", name), mod, "conv" if name.startswith("conv") else "linear")
        yield from _entries_norm(lp + ("norm1",), layer.norm1)
        yield from _entries_norm(lp + ("norm2",), layer.norm2)
    yield from _entries_norm(path + ("final_norm",), block.final_norm)


def _entries_wn(path, conv, layout="conv"):
    """{v, g, b}; g's layout is v's ([1, 1, out] <-> [out, 1, 1] for a conv)."""
    yield path + ("v",), conv.v, layout
    yield path + ("g",), conv.g, layout
    yield path + ("b",), conv.bias, "same"


def _entries_res_block(path, block):
    for i, conv in enumerate(block.layers):
        lp = path + ("layers", i)
        if isinstance(conv, WNConv1d):
            yield from _entries_wn(lp, conv)
        else:
            yield from _entries_linear(lp, conv, "conv")


def _entries_duration_predictor(mod):
    for i, (conv, norm) in enumerate(zip(mod.convs, mod.norms)):
        yield from _entries_linear(("duration_predictor", "convs", i), conv, "conv")
        yield from _entries_norm(("duration_predictor", "norms", i), norm)
    yield from _entries_linear(("duration_predictor", "out"), mod.out)
    if mod.spk_embedding is not None:
        yield ("duration_predictor", "spk_embedding", "table"), mod.spk_embedding, "same"
        yield from _entries_linear(("duration_predictor", "spk_projection"), mod.spk_projection)


def _entries_postnet(mod: Postnet):
    for i, (conv, norm) in enumerate(zip(mod.convs, mod.norms)):
        yield from _entries_linear(("convs", i), conv, "conv")
        for name in ("scale", "bias", "mean", "var"):
            yield ("norms", i, name), getattr(norm, name), "same"


def _entries_cnn(model: EftsCNN):
    """A training model's parameters (a shared key and value once, as the key)."""
    cfg = model.cfg
    yield ("text_embedding", "table"), model.text_embedding, "same"
    yield from _entries_res_block(("text_encoder",), model.text_encoder)
    yield from _entries_linear(("text_key",), model.text_key)
    if not cfg.share_text_encoder_key_value:
        yield from _entries_linear(("text_value",), model.text_value)
    yield from _entries_linear(("mel_prenet",), model.mel_prenet)
    yield from _entries_res_block(("mel_encoder",), model.mel_encoder)
    if cfg.use_mel_query_fc:
        yield from _entries_linear(("mel_query_fc",), model.mel_query_fc)
    yield from _entries_res_block(("decoder",), model.decoder)
    yield from _entries_linear(("mel_out",), model.mel_out)
    yield from _entries_duration_predictor(model.duration_predictor)


def _entries_transformer(model: EftsTransformer):
    yield ("text_embedding", "table"), model.text_embedding, "same"
    yield ("pe_scale",), model.pe_scale, "same"
    yield from _entries_block(("text_encoder",), model.text_encoder)
    yield from _entries_linear(("text_value",), model.text_value)
    if model.training_modules:
        yield from _entries_linear(("text_key",), model.text_key)
        yield from _entries_linear(("mel_prenet",), model.mel_prenet)
        yield from _entries_block(("mel_encoder",), model.mel_encoder)
    yield from _entries_block(("decoder",), model.decoder)
    yield from _entries_linear(("mel_out",), model.mel_out)
    yield from _entries_duration_predictor(model.duration_predictor)


def _entries_generator(gen: HiFiGANTrainGenerator):
    yield from _entries_wn(("conv_pre",), gen.conv_pre)
    for i, up in enumerate(gen.ups):
        yield from _entries_wn(("ups", i), up, "conv_transpose")
    for i, block in enumerate(gen.resblocks):
        for name, convs in block.named_children():  # convs1/convs2 or convs
            for j, conv in enumerate(convs):
                yield from _entries_wn(("resblocks", i, name, j), conv)
    yield from _entries_wn(("conv_post",), gen.conv_post)


def _entries_discriminators(disc: Discriminators):
    for i, d in enumerate(disc.mpd.discriminators):
        for j, conv in enumerate(d.convs):
            yield from _entries_wn(("mpd", "discriminators", i, "convs", j), conv, "conv2d")
        yield from _entries_wn(("mpd", "discriminators", i, "conv_post"), d.conv_post, "conv2d")
    for i, d in enumerate(disc.msd.discriminators):
        for j, conv in enumerate([*d.convs, d.conv_post]):
            path = ("msd", "discriminators", i) + (("convs", j) if j < len(d.convs) else ("conv_post",))
            if isinstance(conv, SNConv1d):
                yield path + ("w_orig",), conv.w_orig, "conv"
                yield path + ("u",), conv.u, "same"
                yield path + ("v",), conv.v, "same"
                yield path + ("b",), conv.bias, "same"
            else:
                yield from _entries_wn(path, conv)


def _load_entries(entries, tree):
    for path, param, layout in entries:
        value = tree
        for key in path:
            value = value[key]
        _set(param, _TO_PORT[layout](np.asarray(value, np.float32)))


def _load_transformer_block(block, p):
    _load_entries(_entries_block((), block), p)


def _put(tree, path, value):
    """Set tree[path] = value, creating dicts and lists (int keys, in order)."""
    for key, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(tree, list):
            if key == len(tree):
                tree.append(child)
            tree = tree[key]
        else:
            tree = tree.setdefault(key, child)
    if isinstance(tree, list):
        tree.append(value)
    else:
        tree[path[-1]] = value


@torch.no_grad()
def efts_cnn_from_jax(params: dict, cfg: EftsCNNConfig, device="cuda", trainable: bool = False) -> EftsCNN:
    """An inference model folds weight norm here (f64 on the host) and
    ignores the text key, mel prenet and mel encoder (training only; with a
    shared key and value the key's weights become the value's);
    `trainable=True` keeps {v, g}, loads the training modules and makes
    every parameter require a gradient."""
    dev = resolve_device(device)
    if trainable:
        model = EftsCNN(cfg, training_modules=True)
        _load_entries(_entries_cnn(model), params)
        model.requires_grad_(True)
        return model.to(dev).train()
    p = fold_weight_norm(params)
    model = EftsCNN(cfg)
    _set(model.text_embedding, p["text_embedding"]["table"])
    for block in ("text_encoder", "decoder"):
        for mod, lp in zip(getattr(model, block).layers, p[block]["layers"], strict=True):
            _load_conv(mod, lp)
    value = p["text_key"] if cfg.share_text_encoder_key_value else p["text_value"]
    _load_linear(model.text_value, value)
    _load_linear(model.mel_out, p["mel_out"])
    _load_duration_predictor(model.duration_predictor, p["duration_predictor"])
    return model.to(dev).eval()


@torch.no_grad()
def efts_cnn_to_jax(model: EftsCNN, grads: bool = False) -> dict:
    """A training model's parameters (or, with `grads`, their `.grad`, zeros
    where there is none) as a numpy tree with the JAX package's keys and
    layouts, weight norm as {v, g, b}."""
    return _tree_from_entries(_entries_cnn(model), _grad if grads else (lambda p: p))


@torch.no_grad()
def efts_transformer_from_jax(params: dict, cfg: EftsTransformerConfig, device="cuda",
                              trainable: bool = False) -> EftsTransformer:
    """An inference model ignores the text key, mel prenet and mel encoder
    (training only); `trainable=True` loads them and makes every parameter
    require a gradient."""
    dev = resolve_device(device)
    model = EftsTransformer(cfg, training_modules=trainable)
    _load_entries(_entries_transformer(model), fold_weight_norm(params))
    model.requires_grad_(trainable)
    return model.to(dev).train(trainable)


@torch.no_grad()
def efts_transformer_to_jax(model: EftsTransformer, grads: bool = False) -> dict:
    """The model's parameters (or, with `grads`, their `.grad`, zeros where
    there is none) as a numpy tree with the JAX package's keys and layouts."""
    return _tree_from_entries(_entries_transformer(model), _grad if grads else (lambda p: p))


@torch.no_grad()
def duration_model_from_jax(params: dict, cfg: DurationModelConfig, device="cuda",
                            trainable: bool = False) -> DurationModel:
    """The DurationModel of a JAX DurationModel tree (its predictor with the
    speaker table and projection when the config has them)."""
    dev = resolve_device(device)
    model = DurationModel(cfg)
    _load_entries(_entries_duration_predictor(model.duration_predictor), params)
    model.requires_grad_(trainable)
    return model.to(dev).train(trainable)


@torch.no_grad()
def duration_model_to_jax(model: DurationModel, grads: bool = False) -> dict:
    """The model's parameters (or, with `grads`, their `.grad`) as the JAX tree."""
    return _tree_from_entries(_entries_duration_predictor(model.duration_predictor),
                              _grad if grads else (lambda p: p))


@torch.no_grad()
def postnet_from_jax(params: dict, device="cuda") -> Postnet:
    """The postnet of a JAX postnet tree ({convs, norms: {scale, bias, mean,
    var}}), its widths read from the tree."""
    dev = resolve_device(device)
    convs = params["convs"]
    k, odim, n_chans = np.asarray(convs[0]["w"]).shape
    mod = Postnet(odim=odim, n_layers=len(convs), n_chans=n_chans, n_filts=k)
    _load_entries(_entries_postnet(mod), params)
    return mod.to(dev)


@torch.no_grad()
def postnet_to_jax(mod: Postnet) -> dict:
    return _tree_from_entries(_entries_postnet(mod))


def _tree_from_entries(entries, value_of=lambda p: p) -> dict:
    """The entries as a JAX tree of `value_of(parameter)` (zeros where it is
    None), in the JAX layouts."""
    tree: dict = {}
    for path, param, layout in entries:
        t = value_of(param)
        value = np.zeros(tuple(param.shape), np.float32) if t is None else t.detach().float().cpu().numpy()
        _put(tree, path, np.array(_TO_JAX[layout](value), order="C"))
    return tree


def _grad(param):
    return param.grad


def _named(module, grads: dict):
    """value_of for `_tree_from_entries`: a parameter's entry in `grads`
    ({name: tensor}, named as `module` names its parameters)."""
    names = {id(p): n for n, p in module.named_parameters()}
    return lambda p: grads.get(names.get(id(p)))


@torch.no_grad()
def generator_from_jax(params: dict, cfg: HiFiGANConfig, device="cuda") -> HiFiGANTrainGenerator:
    """The trainable generator of a JAX generator tree ({v, g, b} convs),
    every parameter requiring a gradient."""
    dev = resolve_device(device)
    gen = HiFiGANTrainGenerator(cfg)
    _load_entries(_entries_generator(gen), params)
    return gen.requires_grad_(True).to(dev)


@torch.no_grad()
def generator_to_jax(gen: HiFiGANTrainGenerator) -> dict:
    """The trainable generator's parameters as the JAX tree, {v, g, b}."""
    return _tree_from_entries(_entries_generator(gen))


@torch.no_grad()
def gan_state_from_jax(state_tree: dict, voc_cfg: HiFiGANConfig, gen_tx, disc_tx, device="cuda") -> dict:
    """The port's GAN state {"gen": {"params", "opt_state"}, "disc":
    {"params", "opt_state"}, "step"[, "ema"]} from a JAX GAN state's
    parameters (its "gen" and "disc" "params", its "step" and, when present,
    its "ema"); the optimizer states are `gen_tx.init` / `disc_tx.init`'s."""
    dev = resolve_device(device)
    gen = generator_from_jax(state_tree["gen"]["params"], voc_cfg, dev)
    disc = Discriminators()
    _load_entries(_entries_discriminators(disc), state_tree["disc"]["params"])
    disc = disc.requires_grad_(True).to(dev)
    state = {"gen": {"params": gen, "opt_state": gen_tx.init(_trainable(gen))},
             "disc": {"params": disc, "opt_state": disc_tx.init(_trainable(disc))},
             "step": int(np.asarray(state_tree.get("step", 0)))}
    if "ema" in state_tree:
        state["ema"] = generator_from_jax(state_tree["ema"], voc_cfg, dev).requires_grad_(False)
    return state


def _trainable(module) -> dict:
    return {n: p for n, p in module.named_parameters() if p.requires_grad}


@torch.no_grad()
def gan_state_to_jax(state: dict, grads: dict | None = None) -> dict:
    """A port GAN state's parameters as the JAX state tree ({"gen":
    {"params"}, "disc": {"params": {"mpd", "msd"}}, "step"[, "ema"]}), u
    and v included. With `grads` ({"gen": {name: tensor}, "disc": {name:
    tensor}}, named as the modules' parameters) the tree holds those
    gradients instead, zeros for u, v and any parameter without one."""
    gen, disc = state["gen"]["params"], state["disc"]["params"]
    g_value = _named(gen, grads["gen"]) if grads is not None else (lambda p: p)
    d_value = _named(disc, grads["disc"]) if grads is not None else (lambda p: p)
    tree = {"gen": {"params": _tree_from_entries(_entries_generator(gen), g_value)},
            "disc": {"params": _tree_from_entries(_entries_discriminators(disc), d_value)},
            "step": int(state["step"])}
    if "ema" in state and grads is None:
        tree["ema"] = generator_to_jax(state["ema"])
    return tree


@torch.no_grad()
def hifigan_generator_from_jax(params: dict, cfg: HiFiGANConfig, device="cuda") -> HiFiGANGenerator:
    dev = resolve_device(device)
    p = fold_weight_norm(params)
    model = HiFiGANGenerator(cfg)
    _load_conv(model.conv_pre, p["conv_pre"])
    _load_conv(model.conv_post, p["conv_post"])
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i, (up, stage) in enumerate(zip(model.ups, model.stages)):
        _load_conv_transpose(up, p["ups"][i])
        blocks = p["resblocks"][i * n_kernels:(i + 1) * n_kernels]
        if cfg.resblock == "2":
            for branch, block in zip(stage.convs, blocks, strict=True):
                for conv, cp in zip(branch, block["convs"], strict=True):
                    _load_conv(conv, cp)
            continue
        ws, bs = [], []
        for block in blocks:
            for c1, c2 in zip(block["convs1"], block["convs2"], strict=True):
                for conv in (c1, c2):
                    ws.append(np.transpose(conv["w"], (0, 2, 1)))  # [k, out, in]
                    bs.append(conv["b"])
        stage.load(ws, np.stack(bs))
    return model.to(dev).eval()


def _fold_dim0(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """g * v / ||v||, the norm over every axis but the first (torch's
    `weight_norm(dim=0)`: a Conv1d's output channels, a ConvTranspose1d's
    input channels), in f64."""
    v = np.asarray(v, np.float64)
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    return (np.asarray(g, np.float64).reshape(norm.shape) * v / norm).astype(np.float32)


@torch.no_grad()
def bigvgan_generator_from_state_dict(sd: dict, cfg: BigVGANConfig, device="cuda") -> BigVGANGenerator:
    """NVIDIA/BigVGAN's generator state dict (the "generator" entry of its
    checkpoints; tensors or numpy arrays) -> the port's BigVGANGenerator on
    `device` ("cuda" unless the caller passes "cpu"). A weight-normed layer's
    `.weight_g` / `.weight_v` are folded here (`_fold_dim0`); a folded file's
    `.weight` is taken as it is. Every resampling filter (`.upsample.filter`,
    `.downsample.lowpass.filter`) must equal `ops/alias_free.py:
    kaiser_sinc_filter` to rounding, else this raises: the port computes its
    own."""
    dev = resolve_device(device)
    h = kaiser_sinc_filter().numpy()
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}
    port = {}
    for key, value in sd.items():
        if key.endswith(".filter"):
            if value.size != h.size or not np.allclose(value.reshape(-1), h, rtol=0.0, atol=1e-6):
                raise ValueError(f"{key} is not the 12-tap Kaiser-windowed sinc of BigVGAN's activations")
        elif key.endswith(".weight_v"):
            base = key[:-len(".weight_v")]
            port[base + ".weight"] = _fold_dim0(value, sd[base + ".weight_g"])
        elif not key.endswith(".weight_g"):
            port[key] = value
    model = BigVGANGenerator(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in port.items()}, strict=True)
    return model.to(dev).eval()
