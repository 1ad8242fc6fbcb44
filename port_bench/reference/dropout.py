"""The dropout masks of the port's training step, drawn again from the same seeds.

A frozen copy of the derivation that the port's dropout follows: a CPU
`torch.Generator` is the key; splitting it into n keys draws n integers in
[0, 2**62) from it and seeds a fresh CPU generator with each; one dropout
draws one such integer, seeds a generator on the activation's device with
it and keeps each element where `torch.rand` of the activation's shape is
below 1 - rate, scaling the kept ones by 1 / (1 - rate). Given the step's
key, the reference draws the same masks as long as it splits its keys in
the same tree: the model's forward into one key per tower (and the
duration predictor), a tower into one key per layer, a transformer layer
into four (attention probabilities, the two residual branches, the
feed-forward).
"""

from __future__ import annotations

import torch


def _draws(key: torch.Generator, n: int) -> list[int]:
    return torch.randint(0, 2**62, (n,), generator=key).tolist()


def split(key: torch.Generator, n: int) -> list[torch.Generator]:
    return [torch.Generator().manual_seed(s) for s in _draws(key, n)]


def dropout(x: torch.Tensor, rate: float, key: torch.Generator | None) -> torch.Tensor:
    if key is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(_draws(key, 1)[0])
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
