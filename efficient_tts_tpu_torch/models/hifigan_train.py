"""HiFi-GAN's training side: the trainable generator and the two discriminators.

Counterpart of `efficient_tts_tpu/models/hifigan.py`'s training half:
`init_generator` (:82-119) with `generator` (:145-255) in its plain form
(`mrf_impl="xla"`, the packing and upsample strategies being exact
re-layouts for the TPU), the multi-period discriminator (:709-751,
:1081-1124) and the multi-scale one with its spectral norm (:764-853,
:1008-1035, :1127-1180; the grouped convs as `groups=`, the `bgc`,
`dense` and `vjp:` lowerings being re-layouts for XLA).

Every layer is channels-last as in the JAX package ([B, T, C]; the
period discriminators fold the waveform to [B, T / p, p, 1]), so feature
maps and logits have the JAX shapes. `compute_dtype` casts the input of a
tower, and every conv then runs in the activations' dtype with its weight
cast from the f32 parameters; the generator's tanh runs in f32. The
weight-norm and spectral-norm layers are `nn/layers.py`'s; parameters
start frozen and the weight bridge (`compat.py`) loads them and makes them
trainable. `HiFiGANTrainGenerator.fold` returns the inference
`HiFiGANGenerator`, whose MRF stages run the card's kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.models.hifigan import LRELU_SLOPE, HiFiGANConfig, HiFiGANGenerator
from efficient_tts_tpu_torch.nn.layers import (SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d, avg_pool1d,
                                               leaky_relu)
from efficient_tts_tpu_torch.ops.mrf import true_div

MPD_PERIODS = (2, 3, 5, 7, 11)
# (in_ch, out_ch, kernel, stride, groups, padding) of a scale discriminator's convs
SCALE_SPECS = (
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
)


def _cast(x, compute_dtype):
    return x if compute_dtype is None else x.to(compute_dtype)


class ResBlock1(nn.Module):
    """`_resblock1`: per dilation d, x + conv2(leaky(conv1_d(leaky(x))))."""

    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(WNConv1d(ch, ch, k, d) for d in dilations)
        self.convs2 = nn.ModuleList(WNConv1d(ch, ch, k) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE)) + x
        return x


class ResBlock2(nn.Module):
    """`_resblock2`: per dilation d, x + conv_d(leaky(x))."""

    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.convs = nn.ModuleList(WNConv1d(ch, ch, k, d) for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = c(leaky_relu(x, LRELU_SLOPE)) + x
        return x


class HiFiGANTrainGenerator(nn.Module):
    """The generator with weight norm as {v, g} on conv_pre, the upsamples
    (norm per input channel), every ResBlock conv and conv_post; parameter
    names follow the JAX tree (`resblocks.{i}.convs1.{j}`, ...)."""

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', got {cfg.resblock!r}")
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList(
            WNConvTranspose1d(c0 // 2**i, c0 // 2 ** (i + 1), k, u, (k - u) // 2)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            block(c0 // 2 ** (i + 1), k, dils)
            for i in range(len(cfg.upsample_rates))
            for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        self.conv_post = WNConv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7)

    def forward(self, mel, compute_dtype=None):
        """[B, T, num_mels] -> [B, T * total_upsampling] f32 waveform."""
        n = len(self.cfg.resblock_kernel_sizes)
        x = self.conv_pre(_cast(mel, compute_dtype))
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE))
            acc = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                y = block(x)
                acc = y if acc is None else acc + y
            x = true_div(acc, float(n))
        # the reference's F.leaky_relu before conv_post uses torch's default 0.01
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x.float())[..., 0]

    @torch.no_grad()
    def fold(self, device=None) -> HiFiGANGenerator:
        """The inference generator of these weights, on this generator's
        device or `device`: weight norm folded in f64 on the host and the MRF
        stages laid out for the kernels, bit for bit as
        `compat.hifigan_generator_from_jax` loads the same JAX tree."""
        from efficient_tts_tpu_torch import compat

        dev = self.conv_pre.v.device if device is None else device
        return compat.hifigan_generator_from_jax(compat.generator_to_jax(self), self.cfg, device=dev)


class PeriodDiscriminator(nn.Module):
    """`DiscriminatorP`: the waveform reflect-padded to a multiple of the
    period and folded to [B, T / p, p, 1], then (5, 1) convs at stride (3, 1)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
        self.convs = nn.ModuleList(
            WNConv2d(ic, oc, (kernel_size, 1), (stride, 1) if i < 4 else (1, 1), (2, 0))
            for i, (ic, oc) in enumerate(chans))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x, compute_dtype=None):
        """x [B, T] -> (logits [B, N], feature maps)."""
        b, t = x.shape
        if t % self.period:
            x = F.pad(x[:, None], (0, self.period - t % self.period), mode="reflect")[:, 0]
        h = _cast(x.reshape(b, -1, self.period, 1), compute_dtype)
        fmap = []
        for conv in self.convs:
            h = leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class ScaleDiscriminator(nn.Module):
    """`DiscriminatorS`: strided, grouped convs of `SCALE_SPECS`, spectral-
    normed or weight-normed."""

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        conv = SNConv1d if use_spectral_norm else WNConv1d
        self.convs = nn.ModuleList(conv(ic, oc, k, stride=s, groups=g, padding=p)
                                   for ic, oc, k, s, g, p in SCALE_SPECS)
        self.conv_post = conv(1024, 1, 3, padding=1)

    def forward(self, x, compute_dtype=None):
        h = _cast(x[:, :, None], compute_dtype)
        fmap = []
        for conv in self.convs:
            h = leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def _pairwise(discs, inputs, y, y_hat, compute_dtype, fused):
    """(real logits, fake logits, real fmaps, fake fmaps) of each
    discriminator on its input pair; `fused` runs each once on the [2B]
    concatenation, numerically the same (every op is batch-parallel)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    if fused:
        b = y.shape[0]
        both = torch.cat([y, y_hat], dim=0)
        for d, prep in zip(discs, inputs):
            both = prep(both)
            o, fm = d(both, compute_dtype)
            y_d_rs.append(o[:b])
            y_d_gs.append(o[b:])
            fmap_rs.append([f[:b] for f in fm])
            fmap_gs.append([f[b:] for f in fm])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
    for d, prep in zip(discs, inputs):
        y, y_hat = prep(y), prep(y_hat)
        r, fr = d(y, compute_dtype)
        g, fg = d(y_hat, compute_dtype)
        y_d_rs.append(r)
        y_d_gs.append(g)
        fmap_rs.append(fr)
        fmap_gs.append(fg)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def _pool(x):
    return avg_pool1d(x[:, :, None], 4, 2, 2)[:, :, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(PeriodDiscriminator(p) for p in MPD_PERIODS)

    def forward(self, y, y_hat, compute_dtype=None, fused: bool = False):
        """`mpd_forward`: `fused=True` for the D step, separate passes for the
        G step (the real branch then needs no backward)."""
        same = [lambda x: x] * len(self.discriminators)
        return _pairwise(self.discriminators, same, y, y_hat, compute_dtype, fused)


class MultiScaleDiscriminator(nn.Module):
    """Three scales, the first spectral-normed; scales 2 and 3 see the
    waveform average-pooled (4, 2, 2) once and twice."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(ScaleDiscriminator(use_spectral_norm=i == 0) for i in range(3))

    def forward(self, y, y_hat, compute_dtype=None, fused: bool = False):
        preps = [lambda x: x] + [_pool] * (len(self.discriminators) - 1)
        return _pairwise(self.discriminators, preps, y, y_hat, compute_dtype, fused)

    def power_iteration(self) -> None:
        """Advance every spectral-norm u and v once (`msd_power_iteration`)."""
        for m in self.modules():
            if isinstance(m, SNConv1d):
                m.power_iteration()


class Discriminators(nn.Module):
    """MPD and MSD together: the D side of the GAN state."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()
