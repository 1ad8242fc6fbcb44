"""The reference's PyTorch state dicts -> the port's modules.

Counterpart of `efficient_tts_tpu/compat/torch_import.py`. Reads:
  * the reference EFTS-CNN (`nntts/models/efficient_tts.py`, saved by its
    trainer as {"model": sd, "steps", "epochs"}), weight-normed
    (`.weight_v` / `.weight_g`) or folded (`.weight`):
    `efts_cnn_from_state_dict`;
  * HiFi-GAN generator files (`nntts/vocoders/hifigan_model.py`,
    {"generator": sd}), ResBlock1 or 2, weight-normed or folded:
    `hifigan_generator_from_state_dict` gives the inference generator,
    `hifigan_train_generator_from_state_dict` the trainable one;
  * the discriminators of the official recipe's `do_` files:
    `hifigan_mpd_from_state_dict`, `hifigan_msd_from_state_dict`.

The port's weights already have torch's layouts ([out, in, k] convs, [out,
in] linears, [in, out, k] transposed convs, a conv's g [out, 1, 1] and a
transposed conv's [in, 1, 1]), so a reader renames keys: a weight-normed
layer's `.weight_v` / `.weight_g` are its `.v` / `.g`, a LayerNorm's
`.weight` its `.scale`, and EFTS-CNN's module paths differ
(`text_encoder.layers.{i}.conv.0` is `text_encoder.layers.{i}`,
`mel_output_layer` is `mel_out`, ...: `efts_cnn_layers`). One tensor is
reordered: spectral norm's v, which the port keeps in the JAX package's
tap-major order ([k * in]) and torch in its in-major one ([in * k]).
`compat/torch_export.py` writes through the same tables. Every module is
loaded with `load_state_dict(strict=True)` on the host, then moved to
`device` ("cuda" unless the caller passes "cpu"; without a card it raises).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from efficient_tts_tpu_torch.compat import hifigan_generator_from_jax
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from efficient_tts_tpu_torch.models.hifigan_train import (HiFiGANTrainGenerator, MultiPeriodDiscriminator,
                                                          MultiScaleDiscriminator)
from efficient_tts_tpu_torch.nn.layers import LayerNorm, SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d
from efficient_tts_tpu_torch.utils.device import resolve_device

WEIGHT_NORMED = (WNConv1d, WNConvTranspose1d, WNConv2d)


def layer_names(layer, fold: bool = False) -> tuple:
    """(reference suffix, port attribute) of each tensor of a layer. With
    `fold` a weight-normed layer has a plain `.weight`, whose attribute is
    None: it is g * v / ||v||, made by the exporter."""
    if isinstance(layer, WEIGHT_NORMED):
        return (("weight", None), ("bias", "bias")) if fold else (("weight_v", "v"), ("weight_g", "g"),
                                                                  ("bias", "bias"))
    if isinstance(layer, SNConv1d):
        return ("weight_orig", "w_orig"), ("weight_u", "u"), ("weight_v", "v"), ("bias", "bias")
    if isinstance(layer, LayerNorm):
        return ("weight", "scale"), ("bias", "bias")
    return ("weight", "weight"), ("bias", "bias")  # Conv1d, Linear


def sn_v_order(v: np.ndarray, w_shape, to_reference: bool) -> np.ndarray:
    """Spectral norm's v between the port's tap-major [k * in] and torch's
    in-major [in * k] (w_shape: [out, in, k]); sigma is the same either way."""
    _, in_ch, k = w_shape
    return np.ascontiguousarray(v.reshape((k, in_ch) if to_reference else (in_ch, k)).T.ravel())


def module_layers(module) -> list:
    """(port path, reference prefix, layer) of every layer of a generator or
    discriminator (each weight-normed or spectral-normed): their module paths
    are the reference's."""
    return [(name, name, m) for name, m in module.named_modules() if isinstance(m, (*WEIGHT_NORMED, SNConv1d))]


def efts_cnn_layers(model: EftsCNN) -> list:
    """(port path, reference prefix, layer) of every layer of an EFTS-CNN
    that holds its training modules, in the reference's order; the text
    embedding table (`text_embedding_table.weight`) is apart."""
    if not model.training_modules:
        raise ValueError("the reference's EFTS-CNN holds the training modules (text key, mel prenet, mel encoder): "
                         "use a model built with trainable=True or loaded from a trainer's checkpoint")
    cfg = model.cfg
    layers = [(f"{block}.layers.{i}", f"{block}.layers.{i}.conv.0", conv)
              for block in ("text_encoder", "mel_encoder", "decoder")
              for i, conv in enumerate(getattr(model, block).layers)]
    layers.append(("text_key", "text_encoder_key", model.text_key))
    # a shared key and value is one module in the port, the key alone in the reference
    layers.append(("text_value", "text_encoder_key" if cfg.share_text_encoder_key_value else "text_encoder_value",
                   model.text_value))
    layers.append(("mel_prenet", "mel_prenet.0", model.mel_prenet))
    if cfg.use_mel_query_fc:
        layers.append(("mel_query_fc", "mel_query_fc", model.mel_query_fc))
    layers.append(("mel_out", "mel_output_layer", model.mel_out))
    dp = model.duration_predictor
    for i, (conv, norm) in enumerate(zip(dp.convs, dp.norms, strict=True)):
        layers.append((f"duration_predictor.convs.{i}", f"duration_predictor.conv.{i}.0", conv))
        layers.append((f"duration_predictor.norms.{i}", f"duration_predictor.conv.{i}.2", norm))
    layers.append(("duration_predictor.out", "duration_predictor.linear", dp.out))
    return layers


def _numpy(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}


def _load(module, layers, sd: dict, extra: dict | None = None):
    """Load `module` strictly from the reference state dict `sd` through
    `layers`; `extra` maps further port keys to reference keys."""
    port = {p: sd[r] for p, r in (extra or {}).items()}
    for path, prefix, layer in layers:
        for ref, attr in layer_names(layer):
            value = sd[f"{prefix}.{ref}"]
            if isinstance(layer, SNConv1d) and attr == "v":
                value = sn_v_order(value, layer.w_orig.shape, to_reference=False)
            port[f"{path}.{attr}"] = value
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in port.items()}, strict=True)
    return module


def _res_conv_weight_norm(sd: dict, cfg: EftsCNNConfig) -> bool:
    """Whether the file's res-conv layers are weight-normed; a file that mixes
    weight-normed and folded layers raises."""
    kinds = {f"{block}.layers.{i}.conv.0.weight_v" in sd
             for block, n in (("text_encoder", cfg.n_text_encoder_layer), ("mel_encoder", cfg.n_mel_encoder_layer),
                              ("decoder", cfg.n_decoder_layer))
             for i in range(n)}
    if len(kinds) > 1:
        raise ValueError("the state dict mixes weight-normed (.weight_v, .weight_g) and folded (.weight) "
                         "res-conv layers")
    return kinds.pop()


@torch.no_grad()
def efts_cnn_from_state_dict(sd: dict, cfg: EftsCNNConfig, device="cuda", trainable: bool = False) -> EftsCNN:
    """The reference EFTS-CNN's state dict (numpy arrays or tensors) -> the
    port's EftsCNN with its training modules on `device`. The res-conv layers
    are built as the file holds them: weight-normed ({v, g}) or plain, whatever
    `cfg.use_weight_norm` says (the model's cfg says which). `trainable=True`
    makes every parameter trainable; else weight norm is folded (f64 on the
    host, as the weight bridge folds) and the model is frozen for inference."""
    dev = resolve_device(device)
    sd = _numpy(sd)
    model = EftsCNN(dataclasses.replace(cfg, use_weight_norm=_res_conv_weight_norm(sd, cfg)), training_modules=True)
    _load(model, efts_cnn_layers(model), sd, {"text_embedding": "text_embedding_table.weight"})
    if trainable:
        return model.requires_grad_(True).to(dev).train()
    return model.fold_weight_norm().to(dev)


@torch.no_grad()
def hifigan_train_generator_from_state_dict(sd: dict, cfg: HiFiGANConfig, device="cuda") -> HiFiGANTrainGenerator:
    """A weight-normed generator file -> the trainable generator, every
    parameter requiring a gradient (a transposed conv's g is per input
    channel, [in, 1, 1], in both). A folded file holds no weight norm to
    train and raises."""
    dev = resolve_device(device)
    sd = _numpy(sd)
    if "conv_pre.weight_v" not in sd:
        raise ValueError("a folded generator file (.weight keys) holds no weight norm to train; the inference and "
                         "serving CLIs read it as it is (--vocoder_checkpoint)")
    gen = HiFiGANTrainGenerator(cfg)
    return _load(gen, module_layers(gen), sd).requires_grad_(True).to(dev)


@torch.no_grad()
def hifigan_mpd_from_state_dict(sd: dict, device="cuda") -> MultiPeriodDiscriminator:
    """`MultiPeriodDiscriminator.state_dict()` of the official recipe (5 period
    discriminators of 5 convs and conv_post, weight-normed) -> the port's,
    trainable."""
    dev = resolve_device(device)
    mpd = MultiPeriodDiscriminator()
    return _load(mpd, module_layers(mpd), _numpy(sd)).requires_grad_(True).to(dev)


@torch.no_grad()
def hifigan_msd_from_state_dict(sd: dict, device="cuda") -> MultiScaleDiscriminator:
    """`MultiScaleDiscriminator.state_dict()` (3 scale discriminators of 7 convs
    and conv_post; the first spectral-normed, its u and v kept) -> the
    port's, trainable (u and v are buffers)."""
    dev = resolve_device(device)
    msd = MultiScaleDiscriminator()
    return _load(msd, module_layers(msd), _numpy(sd)).requires_grad_(True).to(dev)


def load_reference_checkpoint(path: str) -> dict:
    """A reference checkpoint saved with `torch.save`, on the host: {"model":
    {name: numpy array}, "steps", "epochs"}. Trainer files hold {"model": sd,
    "steps", "epochs"}, HiFi-GAN generator files {"generator": sd}; a bare
    state dict is taken as it is. Optimizer state is not read."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model = state
    for key in ("model", "generator"):
        if isinstance(state, dict) and key in state:
            model = state[key]
            break
    meta = state if isinstance(state, dict) else {}
    return {"model": _numpy(model), "steps": int(meta.get("steps", 0)), "epochs": int(meta.get("epochs", 0))}


def _torch_conv_to_tree(sd: dict, prefix: str, transposed: bool) -> dict:
    """A torch conv ([out, in, k]; transposed [in, out, k]) as the JAX tree's
    WIO {v, g, b} or {w, b}. torch's weight norm keeps dim 0: the output
    channels of a Conv1d, the input channels of a ConvTranspose1d."""
    perm = (2, 0, 1) if transposed else (2, 1, 0)
    if prefix + ".weight_v" in sd:
        g = sd[prefix + ".weight_g"]
        g = g.reshape(1, g.size, 1) if transposed else g.reshape(1, 1, g.size)
        return {"v": np.transpose(sd[prefix + ".weight_v"], perm), "g": g, "b": sd[prefix + ".bias"]}
    return {"w": np.transpose(sd[prefix + ".weight"], perm), "b": sd[prefix + ".bias"]}


def hifigan_generator_from_state_dict(sd: dict, cfg: HiFiGANConfig, device="cuda") -> HiFiGANGenerator:
    """The reference HiFi-GAN generator's state dict (names of
    `nntts/vocoders/hifigan_model.py`: conv_pre, ups.i, resblocks.i.convs1.j /
    convs2.j (ResBlock1) or convs.j (ResBlock2), conv_post; '.weight_v' and
    '.weight_g' or a folded '.weight') -> the port's inference generator on
    `device`, weight norm folded here."""
    sd = _numpy(sd)
    n_ups, n_kernels = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    tree = {
        "conv_pre": _torch_conv_to_tree(sd, "conv_pre", False),
        "ups": [_torch_conv_to_tree(sd, f"ups.{i}", True) for i in range(n_ups)],
        "resblocks": [],
        "conv_post": _torch_conv_to_tree(sd, "conv_post", False),
    }
    names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    for i in range(n_ups * n_kernels):
        n_dil = len(cfg.resblock_dilation_sizes[i % n_kernels])
        tree["resblocks"].append({name: [_torch_conv_to_tree(sd, f"resblocks.{i}.{name}.{j}", False)
                                         for j in range(n_dil)] for name in names})
    return hifigan_generator_from_jax(tree, cfg, device=device)
