"""Seeded random parameters, as numpy trees in the JAX package's layout.

Same keys, shapes and distributions as `efficient_tts_tpu/models/
efficient_tts.py:init`, `models/efficient_tts_transformer.py:init`,
`models/hifigan.py:init_generator`, `init_mpd` and `init_msd`, the GAN
state of `train/hifigan_train_step.py:init_gan_state`,
`models/duration_model.py:init` and `nn/postnet.py:postnet_init` (torch-style
kaiming-uniform convs and linears, N(0, 1) embedding, N(0, 0.01) HiFi-GAN
upsample and resblock convs, weight norm as {v, g, b} with g = ||v||,
spectral norm as {w_orig, u, v, b} with unit N(0, 1) u and v), drawn from
numpy rather than `jax.random`, so the numbers differ. Feed the result to
`compat.py`.
"""

from __future__ import annotations

import math

import numpy as np

from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.models.hifigan_train import MPD_PERIODS, SCALE_SPECS


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _kaiming(rng, shape, fan_in):
    # torch's default a=sqrt(5): bound = sqrt(2/6) * sqrt(3/fan_in) = 1/sqrt(fan_in)
    return _uniform(rng, shape, math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in))


def _bias(rng, n, fan_in):
    return _uniform(rng, (n,), 1.0 / math.sqrt(fan_in))


def _linear(rng, din, dout):
    return {"w": _kaiming(rng, (din, dout), din), "b": _bias(rng, dout, din)}


def _conv(rng, cin, cout, k, init="torch", transpose=False):
    fan_in = cout * k if transpose else cin * k
    shape = (k, cin, cout)
    w = _kaiming(rng, shape, fan_in) if init == "torch" else (
        0.01 * rng.standard_normal(shape)).astype(np.float32)
    return {"w": w, "b": _bias(rng, cout, fan_in)}


def _conv2d(rng, cin, cout, kh, kw):
    fan_in = cin * kh * kw
    return {"w": _kaiming(rng, (kh, kw, cin, cout), fan_in), "b": _bias(rng, cout, fan_in)}


def _spectral_norm(rng, p):
    k, cin, cout = p["w"].shape
    u, v = rng.standard_normal(cout), rng.standard_normal(k * cin)
    return {"w_orig": p["w"], "u": (u / np.linalg.norm(u)).astype(np.float32),
            "v": (v / np.linalg.norm(v)).astype(np.float32), "b": p["b"]}


def _weight_norm(p, preserved_axis=-1):
    w = p["w"]
    axes = tuple(i for i in range(w.ndim) if i != preserved_axis % w.ndim)
    return {"v": w, "g": np.sqrt(np.sum(w * w, axis=axes, keepdims=True)), "b": p["b"]}


def _res_block(rng, n_layers, c, k, use_wn):
    layers = [_conv(rng, c, c, k) for _ in range(n_layers)]
    return {"layers": [_weight_norm(p) if use_wn else p for p in layers]}


def _layer_norm(c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def _duration_predictor(rng, c, n_layers, k=3):
    return {
        "convs": [_conv(rng, c, c, k) for _ in range(n_layers)],
        "norms": [_layer_norm(c) for _ in range(n_layers)],
        "out": _linear(rng, c, 1),
    }


def _embedding(rng, n, dim):
    return {"table": rng.standard_normal((n, dim)).astype(np.float32)}


def init_efts(seed: int, cfg: EftsCNNConfig) -> dict:
    rng = np.random.default_rng(seed)
    c = cfg.n_channels
    params = {
        "text_embedding": _embedding(rng, cfg.num_symbols, cfg.symbol_embedding_dim),
        "text_encoder": _res_block(rng, cfg.n_text_encoder_layer, c, cfg.k_size, cfg.use_weight_norm),
        "text_key": _linear(rng, c, c),
        "mel_prenet": _linear(rng, cfg.odim, c),
        "mel_encoder": _res_block(rng, cfg.n_mel_encoder_layer, c, cfg.k_size, cfg.use_weight_norm),
        "decoder": _res_block(rng, cfg.n_decoder_layer, c, cfg.k_size, cfg.use_weight_norm),
        "mel_out": _linear(rng, c, cfg.odim),
        "duration_predictor": _duration_predictor(rng, c, cfg.n_duration_layer),
    }
    if not cfg.share_text_encoder_key_value:
        params["text_value"] = _linear(rng, c, c)
    if cfg.use_mel_query_fc:
        params["mel_query_fc"] = _linear(rng, c, c)
    return params


def _transformer_block(rng, n_layers, cfg: EftsTransformerConfig):
    c, k, hidden = cfg.n_channels, cfg.kernel_size, cfg.ff_hidden

    def layer():
        ff = ({"conv1": _conv(rng, c, hidden, k), "conv2": _conv(rng, hidden, c, k)} if cfg.use_conv_ff
              else {"w1": _linear(rng, c, hidden), "w2": _linear(rng, hidden, c)})
        return {"self_attn": {name: _linear(rng, c, c) for name in ("q", "k", "v", "out")},
                "ff": ff, "norm1": _layer_norm(c), "norm2": _layer_norm(c)}

    return {"layers": [layer() for _ in range(n_layers)], "final_norm": _layer_norm(c)}


def init_efts_transformer(seed: int, cfg: EftsTransformerConfig) -> dict:
    rng = np.random.default_rng(seed)
    c = cfg.n_channels
    return {
        "text_embedding": _embedding(rng, cfg.num_symbols, c),
        "text_encoder": _transformer_block(rng, cfg.n_text_encoder_layer, cfg),
        "text_key": _linear(rng, c, c),
        "text_value": _linear(rng, c, c),
        "mel_prenet": _linear(rng, cfg.odim, c),
        "mel_encoder": _transformer_block(rng, cfg.n_mel_encoder_layer, cfg),
        "decoder": _transformer_block(rng, cfg.n_decoder_layer, cfg),
        "mel_out": _linear(rng, c, cfg.odim),
        "duration_predictor": _duration_predictor(rng, c, cfg.n_duration_layer),
        "pe_scale": np.ones((), np.float32),
    }


def init_generator(seed: int, cfg: HiFiGANConfig) -> dict:
    rng = np.random.default_rng(seed)
    c0 = cfg.upsample_initial_channel
    params = {
        "conv_pre": _weight_norm(_conv(rng, cfg.num_mels, c0, 7)),
        "ups": [],
        "resblocks": [],
    }
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        p = _conv(rng, c0 // 2**i, c0 // 2 ** (i + 1), k, init="normal", transpose=True)
        params["ups"].append(_weight_norm(p, preserved_axis=1))
    ch = c0
    for i in range(len(cfg.upsample_rates)):
        ch = c0 // 2 ** (i + 1)
        names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            params["resblocks"].append({
                name: [_weight_norm(_conv(rng, ch, ch, k, init="normal")) for _ in dils] for name in names
            })
    params["conv_post"] = _weight_norm(_conv(rng, ch, 1, 7))
    return params


def init_mpd(rng) -> dict:
    """The five period discriminators (`hifigan.py:init_mpd`)."""
    chans = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
    return {"discriminators": [
        {"convs": [_weight_norm(_conv2d(rng, ic, oc, 5, 1)) for ic, oc in chans],
         "conv_post": _weight_norm(_conv2d(rng, 1024, 1, 3, 1))} for _ in MPD_PERIODS]}


def init_msd(rng) -> dict:
    """The three scale discriminators, the first spectral-normed (`init_msd`)."""
    discs = []
    for i in range(3):
        norm = (lambda p: _spectral_norm(rng, p)) if i == 0 else _weight_norm
        discs.append({"convs": [norm(_conv(rng, ic // g, oc, k)) for ic, oc, k, _, g, _ in SCALE_SPECS],
                      "conv_post": norm(_conv(rng, 1024, 1, 3))})
    return {"discriminators": discs}


def init_gan_state(seed: int, cfg: HiFiGANConfig, ema: bool = False) -> dict:
    """{"gen": {"params"}, "disc": {"params": {"mpd", "msd"}}, "step": 0[,
    "ema"]}, the parameters of the JAX package's GAN state (no optimizer
    state: the bridge starts the moments at zero)."""
    rng = np.random.default_rng(seed)
    gen = init_generator(int(rng.integers(2**31)), cfg)
    state = {"gen": {"params": gen}, "disc": {"params": {"mpd": init_mpd(rng), "msd": init_msd(rng)}},
             "step": 0}
    if ema:
        state["ema"] = gen
    return state


def init_duration_model(seed: int, cfg: DurationModelConfig) -> dict:
    """{"duration_predictor": {convs, norms, out[, spk_embedding, spk_projection]}}."""
    rng = np.random.default_rng(seed)
    c = cfg.duration_predictor_chans
    dp = _duration_predictor(rng, c, cfg.duration_predictor_layers, cfg.duration_predictor_kernel_size)
    if cfg.spk_embed_dim is not None:
        if cfg.num_spks is None:
            raise ValueError("num_spks has to be set.")
        dp["spk_embedding"] = _embedding(rng, cfg.num_spks, cfg.spk_embed_dim)
        proj_in = cfg.spk_embed_dim + (cfg.idim if cfg.spk_embed_integration_type == "concat" else 0)
        dp["spk_projection"] = _linear(rng, proj_in, c)
    return {"duration_predictor": dp}


def init_postnet(seed: int, odim: int = 80, n_layers: int = 5, n_chans: int = 512, n_filts: int = 5) -> dict:
    """{"convs": [...], "norms": [{scale, bias, mean, var}]}: scale 1, bias 0,
    mean 0, var 1, as JAX's `postnet_init`."""
    rng = np.random.default_rng(seed)
    chans = [odim] + [n_chans] * (n_layers - 1) + [odim]
    return {"convs": [_conv(rng, chans[i], chans[i + 1], n_filts) for i in range(n_layers)],
            "norms": [{**_layer_norm(c), "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
                      for c in chans[1:]]}
