"""Weight bridge: the JAX package's parameter trees -> the port's modules.

Takes the nested dicts of `efficient_tts_tpu` (`efts.init`,
`hg.init_generator`, or their checkpoints) holding numpy arrays, with each
conv either weight-normed {v, g, b} or plain {w, b}. Weight norm is folded
once here (eps 0). Layouts: linear [in, out] -> [out, in]; conv WIO
[k, in, out] -> [out, in, k]; transposed conv WIO -> [in, out, k]; MRF
stage convs -> the kernel's [k, out, in], each stage's 18 laid out once.
Parameters that only the training forward uses are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
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
    dp = p["duration_predictor"]
    for mod, cp in zip(model.duration_predictor.convs, dp["convs"], strict=True):
        _load_conv(mod, cp)
    for mod, npar in zip(model.duration_predictor.norms, dp["norms"], strict=True):
        _set(mod.scale, npar["scale"])
        _set(mod.bias, npar["bias"])
    _load_linear(model.duration_predictor.out, dp["out"])
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
