"""Config files: the `config.yml` beside a checkpoint -> the port's model configs.

Counterpart of `efficient_tts_tpu/utils/config.py` (`load_config`,
`dump_config`, `model_config_from_dict`, `vocoder_config_from_dict`,
`vocoder_config_near_checkpoint`). The optimizer block is read by
`train/optim.py:optimizer_from_dict`. A config's top-level `vocoder_name`
picks the vocoder: "HiFiGAN" (the default) or "BigVGAN".

PyYAML is imported only when a file is read, and only when the text is not
JSON: a config written as JSON (which is also YAML) loads without it.
"""

from __future__ import annotations

import dataclasses
import json
import os

from efficient_tts_tpu_torch.models.bigvgan import BigVGANConfig
from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig


def _parse(text: str, path: str) -> dict:
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:
        raise ImportError(f"{path} is not JSON, and reading it as YAML needs PyYAML, which is not installed") from None
    return yaml.safe_load(text)


def load_config(path: str) -> dict:
    with open(path) as f:
        return _parse(f.read(), path) or {}


def dump_config(config: dict, outdir: str) -> str:
    """Write `outdir/config.yml`, from which inference rebuilds the model."""
    import yaml

    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return path


def model_config_from_dict(config: dict):
    """The acoustic model's config from `model_name` / `model_params`."""
    name = config.get("model_name", "EfficientTTSCNN")
    params = dict(config.get("model_params", {}))
    if name == "EfficientTTSCNN":
        # translate reference-style kwargs to dataclass fields
        params.pop("use_weighted_masking", None)  # broken/unused in the reference
        act_params = params.pop("nonlinear_activation_params", None)
        params.pop("nonlinear_activation", None)
        if act_params and "negative_slope" in act_params:
            params["leaky_slope"] = act_params["negative_slope"]
        return EftsCNNConfig(**params)
    if name == "EfficientTTSTransformer":
        params.pop("use_weighted_masking", None)
        return EftsTransformerConfig(**params)
    if name == "DurationModel":
        return DurationModelConfig(**params)
    raise ValueError(f"unknown model_name: {name}")


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


VOCODER_CONFIGS = {"HiFiGAN": HiFiGANConfig, "BigVGAN": BigVGANConfig}


def vocoder_config_from_dict(config: dict) -> HiFiGANConfig | BigVGANConfig:
    """The vocoder's config from a config dict's `vocoder_name` (default
    "HiFiGAN") and `vocoder_params`, nested lists made tuples (the config is
    a frozen, hashable dataclass)."""
    name = config.get("vocoder_name", "HiFiGAN")
    if name not in VOCODER_CONFIGS:
        raise ValueError(f"unknown vocoder_name: {name!r} (expected one of {sorted(VOCODER_CONFIGS)})")
    return VOCODER_CONFIGS[name](**{k: _deep_tuple(v) for k, v in dict(config.get("vocoder_params", {})).items()})


def published_vocoder_config(config: dict) -> HiFiGANConfig | BigVGANConfig:
    """The config of a vocoder repository's own flat `config.json` (its
    widths at the top level, beside training settings this port does not
    read): BigVGAN's when it names an `activation` (NVIDIA/BigVGAN), else
    HiFi-GAN's (jik876/hifi-gan)."""
    cls = BigVGANConfig if "activation" in config else HiFiGANConfig
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _deep_tuple(v) for k, v in config.items() if k in fields})


def vocoder_config_near_checkpoint(path: str | None) -> HiFiGANConfig | BigVGANConfig:
    """The config of a vocoder checkpoint: from the `config.yml` beside it
    when there is one (`vocoder_config_from_dict`), else from a published
    repository's `config.json` beside it (`published_vocoder_config`), else
    the HiFi-GAN V1 defaults."""
    if path:
        here = os.path.dirname(os.path.abspath(path))
        if os.path.exists(os.path.join(here, "config.yml")):
            return vocoder_config_from_dict(load_config(os.path.join(here, "config.yml")))
        if os.path.exists(os.path.join(here, "config.json")):
            return published_vocoder_config(load_config(os.path.join(here, "config.json")))
    return HiFiGANConfig()
