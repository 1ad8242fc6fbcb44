"""The system under test, built from a configuration file and the run's seed.

The one place besides the drivers' calls where the benchmark touches the
port: its config readers, its loading API (`compat.*_from_jax`), its
optimizer registry and its train step. The weights come from
`port_bench/weights.py`; the port gets them as host arrays and keeps its
own copies on the device.
"""

from __future__ import annotations

import math

from port_bench import weights


def model_config(config: dict):
    from efficient_tts_tpu_torch.utils.config import model_config_from_dict

    return model_config_from_dict(config)


def vocoder_config(config: dict):
    from efficient_tts_tpu_torch.utils.config import vocoder_config_from_dict

    return vocoder_config_from_dict(config)


def inference_trees(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(acoustic tree, vocoder tree) of an EFTS-CNN configuration, the
    duration head pinned to `pinned_frames_per_symbol`."""
    if config["model_name"] != "EfficientTTSCNN":
        raise ValueError("synthesis cells serve EFTS-CNN configurations")
    mp = config["model_params"]
    pin = math.log(config["pinned_frames_per_symbol"] + mp["duration_offset"])
    acoustic = weights.make_tree(weights.efts_cnn_spec(mp, training=False, pin=pin),
                                 weights.sub_seed(seed, "acoustic"), device)
    vocoder = weights.make_tree(weights.hifigan_spec(config["vocoder_params"]),
                                weights.sub_seed(seed, "vocoder"), device)
    return acoustic, vocoder


def inference_models(config: dict, trees: tuple, device):
    """The port's inference EFTS-CNN and HiFi-GAN generator on `device`."""
    from efficient_tts_tpu_torch import compat

    acoustic, vocoder = trees
    model = compat.efts_cnn_from_jax(weights.to_numpy(acoustic), model_config(config), device=device)
    voc = compat.hifigan_generator_from_jax(weights.to_numpy(vocoder), vocoder_config(config), device=device)
    return model, voc


def training_tree(config: dict, seed: int, device) -> dict:
    mp = config["model_params"]
    spec = (weights.efts_cnn_spec(mp, training=True) if config["model_name"] == "EfficientTTSCNN"
            else weights.efts_transformer_spec(mp, training=True))
    return weights.make_tree(spec, weights.sub_seed(seed, "acoustic"), device)


def training_step(config: dict, tree: dict, device):
    """(train state, step function) of the port: the trainable model loaded
    from `tree`, the config's optimizer, `make_train_step`."""
    from efficient_tts_tpu_torch import compat
    from efficient_tts_tpu_torch.train.efts_train_step import make_train_step
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state

    cfg = model_config(config)
    load = compat.efts_cnn_from_jax if config["model_name"] == "EfficientTTSCNN" else compat.efts_transformer_from_jax
    model = load(weights.to_numpy(tree), cfg, device=device, trainable=True)
    tx = optimizer_from_dict(config)
    return create_state(model, tx), make_train_step(cfg, tx, device=device)
