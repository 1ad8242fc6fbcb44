"""Eval-time diagnostic plots: IMV curves, alignments, mels.

Copy of `efficient_tts_tpu/utils/plotting.py` (the reference's
`nntts/utils/plotting.py`): the monotonic diagonal of the alignment plot
is EfficientTTS training's check by eye. matplotlib is imported when a
plot is drawn, with the Agg backend; `available()` says whether it is
installed (the card's machine may lack it).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np


def available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_alignment_plot(alignment: np.ndarray, path: str, title: str = "") -> None:
    """alignment [T1, T2] -> heatmap png."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(alignment), aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("mel frames")
    ax.set_ylabel("text positions")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def save_imv_plot(imv: np.ndarray, path: str, title: str = "IMV") -> None:
    """imv [T2] -> monotonic curve png."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(np.asarray(imv))
    ax.set_xlabel("mel frames")
    ax.set_ylabel("text index")
    ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def save_mel_comparison(pred: np.ndarray, target: np.ndarray, path: str) -> None:
    """pred/target [T2, n_mels] -> stacked spectrogram png."""
    plt = _plt()
    fig, axes = plt.subplots(2, 1, figsize=(8, 6))
    for ax, mel, name in zip(axes, [pred, target], ["predicted", "ground truth"]):
        im = ax.imshow(np.asarray(mel).T, aspect="auto", origin="lower", interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
