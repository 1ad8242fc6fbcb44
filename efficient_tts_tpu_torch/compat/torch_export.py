"""The port's modules -> the reference's PyTorch state dicts (the inverse of `torch_import.py`).

Counterpart of `efficient_tts_tpu/compat/torch_export.py`: numpy arrays
keyed by the reference's names, so that weights trained here go back to
the reference's tools. Wrap them with `torch.from_numpy` to save. The keys
and layouts are `torch_import.py`'s tables read the other way:
`efts_cnn_to_state_dict` (a model holding its training modules, weight
norm as {v, g} or folded), `hifigan_generator_to_state_dict` (the trainable
generator), `hifigan_mpd_to_state_dict`, `hifigan_msd_to_state_dict` (u and
v included) and `gan_state_to_torch_checkpoints` (the official recipe's
`g_` / `do_` contents). With `fold=True` each weight-normed layer is
written as a plain `.weight`, folded in f64 on the host as the weight
bridge folds, so a folded file loads into the same inference weights bit
for bit as the weight-normed one.
"""

from __future__ import annotations

import numpy as np
import torch

from efficient_tts_tpu_torch.compat.torch_import import efts_cnn_layers, layer_names, module_layers, sn_v_order
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN
from efficient_tts_tpu_torch.models.hifigan_train import (HiFiGANTrainGenerator, MultiPeriodDiscriminator,
                                                          MultiScaleDiscriminator)
from efficient_tts_tpu_torch.nn.layers import SNConv1d, weight_norm_kernel


def _np(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().cpu())


def _export(layers, fold: bool = False) -> dict:
    sd: dict = {}
    for _, prefix, layer in layers:
        for ref, attr in layer_names(layer, fold):
            if attr is None:
                value = weight_norm_kernel(_np(layer.v), _np(layer.g))
            elif isinstance(layer, SNConv1d) and attr == "v":
                value = sn_v_order(_np(layer.v), layer.w_orig.shape, to_reference=True)
            else:
                value = _np(getattr(layer, attr))
            sd[f"{prefix}.{ref}"] = value
    return sd


@torch.no_grad()
def efts_cnn_to_state_dict(model: EftsCNN, fold: bool = False) -> dict:
    """Inverse of `torch_import.efts_cnn_from_state_dict`: the reference
    EFTS-CNN's state dict of a model holding its training modules, its
    res-conv layers weight-normed or plain as the model holds them (or
    folded, with `fold`)."""
    return {"text_embedding_table.weight": _np(model.text_embedding), **_export(efts_cnn_layers(model), fold)}


@torch.no_grad()
def hifigan_generator_to_state_dict(gen: HiFiGANTrainGenerator, fold: bool = False) -> dict:
    """The official HiFi-GAN generator's state dict (`generator_v1` layout;
    save it as {"generator": sd}), weight-normed or, with `fold`, folded."""
    return _export(module_layers(gen), fold)


@torch.no_grad()
def hifigan_mpd_to_state_dict(mpd: MultiPeriodDiscriminator) -> dict:
    """Inverse of `torch_import.hifigan_mpd_from_state_dict`."""
    return _export(module_layers(mpd))


@torch.no_grad()
def hifigan_msd_to_state_dict(msd: MultiScaleDiscriminator) -> dict:
    """Inverse of `torch_import.hifigan_msd_from_state_dict`."""
    return _export(module_layers(msd))


def gan_state_to_torch_checkpoints(state: dict, fold: bool = False) -> tuple:
    """A port GAN state ({"gen": {"params"}, "disc": {"params"}, "step"}) ->
    (g, do), the contents of the official recipe's `g_<steps>` and
    `do_<steps>` files: {"generator": sd} and {"mpd", "msd", "steps",
    "epoch": 0}. Weights only: the recipe's optimizers start fresh."""
    disc = state["disc"]["params"]
    g = {"generator": hifigan_generator_to_state_dict(state["gen"]["params"], fold)}
    do = {"mpd": hifigan_mpd_to_state_dict(disc.mpd), "msd": hifigan_msd_to_state_dict(disc.msd),
          "steps": int(state["step"]), "epoch": 0}
    return g, do
