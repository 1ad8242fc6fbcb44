"""LSGAN and feature-matching losses of HiFi-GAN training.

Counterpart of `efficient_tts_tpu/losses/gan.py`: `feature_loss` (x2 L1
over every discriminator feature map), the LSGAN `discriminator_loss`
(real -> 1, fake -> 0) and `generator_loss` (fake -> 1). Every mean is
taken in f32, so bf16 discriminator towers reduce exactly as f32 ones do.
"""

from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """(loss, real losses, fake losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean(torch.square(1.0 - dr.float()))
        g_loss = torch.mean(torch.square(dg.float()))
        loss = loss + (r_loss + g_loss)
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """(loss, per-discriminator losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        one = torch.mean(torch.square(1.0 - dg.float()))
        gen_losses.append(one)
        loss = loss + one
    return loss, gen_losses
