"""Weight bridge: the JAX package's parameter trees -> the port's modules.

Takes the nested dicts of `efficient_tts_tpu` (`efts.init`, the
EFTS-Transformer's `init`, `hg.init_generator`, or their checkpoints)
holding numpy arrays, with each conv either weight-normed {v, g, b} or
plain {w, b}. Weight norm is folded
once here (eps 0). Layouts: linear [in, out] -> [out, in]; conv WIO
[k, in, out] -> [out, in, k]; transposed conv WIO -> [in, out, k]; MRF
stage convs -> the kernel's [k, out, in], each stage's 18 laid out once.
Parameters that only the training forward uses are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer, EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from efficient_tts_tpu_torch.nn.layers import fold_weight_norm
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


@torch.no_grad()
def efts_cnn_from_jax(params: dict, cfg: EftsCNNConfig, device="cuda") -> EftsCNN:
    dev = resolve_device(device)
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


def _load_transformer_block(block, p):
    for layer, lp in zip(block.layers, p["layers"], strict=True):
        for name in ("q", "k", "v", "out"):
            _load_linear(getattr(layer.self_attn, name), lp["self_attn"][name])
        for name, fp in lp["ff"].items():  # conv1/conv2 or w1/w2
            (_load_conv if name.startswith("conv") else _load_linear)(getattr(layer.ff, name), fp)
        _load_norm(layer.norm1, lp["norm1"])
        _load_norm(layer.norm2, lp["norm2"])
    _load_norm(block.final_norm, p["final_norm"])


@torch.no_grad()
def efts_transformer_from_jax(params: dict, cfg: EftsTransformerConfig, device="cuda") -> EftsTransformer:
    """The text key, mel prenet and mel encoder (training only) are ignored."""
    dev = resolve_device(device)
    p = fold_weight_norm(params)
    model = EftsTransformer(cfg)
    _set(model.text_embedding, p["text_embedding"]["table"])
    _set(model.pe_scale, p["pe_scale"])
    _load_transformer_block(model.text_encoder, p["text_encoder"])
    _load_transformer_block(model.decoder, p["decoder"])
    _load_linear(model.text_value, p["text_value"])
    _load_linear(model.mel_out, p["mel_out"])
    _load_duration_predictor(model.duration_predictor, p["duration_predictor"])
    return model.to(dev).eval()


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
        ws, bs = [], []
        for block in p["resblocks"][i * n_kernels:(i + 1) * n_kernels]:
            for c1, c2 in zip(block["convs1"], block["convs2"], strict=True):
                for conv in (c1, c2):
                    ws.append(np.transpose(conv["w"], (0, 2, 1)))  # [k, out, in]
                    bs.append(conv["b"])
        stage.load(ws, np.stack(bs))
    return model.to(dev).eval()
