"""HiFi-GAN's generator (V1 family, ResBlock1), mel -> waveform.

conv_pre (k 7); per upsample: leaky 0.1, the transposed conv, then the MRF
stage, the mean of one ResBlock1 per kernel size, each block per dilation d
x + conv_1(leaky(conv_d(leaky(x)))); then leaky 0.01, conv_post (k 7) and
tanh. Channels-last [B, T, C] throughout.
"""

from __future__ import annotations

import torch

from port_bench.reference.ops import Ops, leaky


def generator(p: dict, v: dict, mel: torch.Tensor, ops: Ops) -> torch.Tensor:
    """[B, T, num_mels] -> [B, T * prod(upsample_rates)]."""
    if v["resblock"] != "1":
        raise ValueError("the reference generator holds ResBlock1 stages only")
    x = ops.conv(mel, p["conv_pre"])
    n_k = len(v["resblock_kernel_sizes"])
    for i, u in enumerate(v["upsample_rates"]):
        x = ops.conv_transpose(leaky(x, 0.1), p["ups"][i], u)
        out = None
        for j, dils in enumerate(v["resblock_dilation_sizes"]):
            block = p["resblocks"][i * n_k + j]
            xb = x
            for c1, c2, d in zip(block["convs1"], block["convs2"], dils):
                xb = xb + ops.conv(leaky(ops.conv(leaky(xb, 0.1), c1, d), 0.1), c2)
            out = xb if out is None else out + xb
        x = out / n_k
    return torch.tanh(ops.conv(leaky(x, 0.01), p["conv_post"]))[..., 0]
