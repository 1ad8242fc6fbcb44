"""BigVGAN generator (AMPBlock1, SnakeBeta), mel -> waveform.

Counterpart of NVIDIA/BigVGAN's `bigvgan.py:BigVGAN` at inference, weight
norm folded (`compat.bigvgan_generator_from_state_dict` folds it). In
channels-first notation:

  x = conv_pre(mel)                        k 7, pad 3
  per stage i: x = up_i(x)                 ConvTranspose1d C/2^i -> C/2^(i+1),
                                           kernel k_i, stride u_i, pad (k_i - u_i)/2;
                                           no activation before it
               x = mean over the AMP blocks j of block_j(x)
  an AMP block, per dilation d: x = x + c2(A2(c1_d(A1(x))))
                                           c1_d dilation d, pad d(k - 1)/2;
                                           c2 dilation 1; each A its own
  x = conv_post(A_post(x))                 k 7, pad 3, bias only if use_bias_at_final
  tanh(x) if use_tanh_at_final, else clamp(x, -1, 1)

Each A is the anti-aliased SnakeBeta of `ops/alias_free.py`: 6 x 3 x 6 + 1
= 109 a forward at the published widths. Module and parameter names are the
published state dict's (`conv_pre`, `ups.{i}.0`, `resblocks.{n}.convs1.{j}`,
`.convs2.{j}`, `.activations.{m}.act.{alpha,beta}`, `activation_post`,
`conv_post`), less weight norm's g and v and the filter buffers, which the
port computes itself. Convolutions run on channels-first activations with
cuDNN, f32 unless `compute_dtype` says otherwise; no hand-written kernel
hosts an AMP block, so `mrf_impl` has nothing to choose here. The forward
records the span `bigvgan.generator` with its device time while a torch
profiler runs.

`generator_chunked`, `pipeline.stream_vocoder` and the sequence-parallel
vocoder size their overlap for HiFi-GAN V1's receptive field and refuse a
BigVGAN generator (`models/hifigan.py:require_v1_overlap`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from efficient_tts_tpu_torch.nn.layers import frozen_param
from efficient_tts_tpu_torch.ops.alias_free import anti_aliased_snake_beta, kaiser_sinc_filter, snake_coefficients
from efficient_tts_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """Defaults: `configs/bigvgan_v2_22khz_80band_fmax8k_256x.json` of
    NVIDIA/BigVGAN, the 112M generator."""

    resblock: str = "1"
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256

    @property
    def total_upsampling(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


class _Conv(nn.Module):
    """Conv1d on [B, C, T], weight [out, in, k], 'same' padding d(k - 1)/2."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.weight = frozen_param((cout, cin, k))
        self.bias = frozen_param((cout,)) if bias else None
        self.dilation, self.padding = dilation, dilation * (k - 1) // 2

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, self.weight.to(x.dtype), b, padding=self.padding, dilation=self.dilation)


class _ConvTranspose(nn.Module):
    """ConvTranspose1d on [B, C, T], weight [in, out, k], padding (k - u)/2."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.weight = frozen_param((cin, cout, k))
        self.bias = frozen_param((cout,))
        self.stride, self.padding = stride, (k - stride) // 2

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                                  padding=self.padding)


class _SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = frozen_param((channels,))
        self.beta = frozen_param((channels,))


class Activation1d(nn.Module):
    """One anti-aliased SnakeBeta; the filter is a buffer outside the state dict."""

    def __init__(self, channels: int, logscale: bool):
        super().__init__()
        self.act = _SnakeBeta(channels)
        self.logscale = logscale
        self.register_buffer("filter", kaiser_sinc_filter(), persistent=False)

    def forward(self, x):
        alpha, inv_beta = snake_coefficients(self.act.alpha, self.act.beta, self.logscale)
        return anti_aliased_snake_beta(x, alpha, inv_beta, self.filter)


class AMPBlock1(nn.Module):
    """Per dilation d: x = x + c2(A2(c1_d(A1(x)))); activations [2n] are A1 and [2n + 1] are A2."""

    def __init__(self, channels: int, k: int, dilations, logscale: bool):
        super().__init__()
        self.convs1 = nn.ModuleList(_Conv(channels, channels, k, d) for d in dilations)
        self.convs2 = nn.ModuleList(_Conv(channels, channels, k) for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(channels, logscale) for _ in range(2 * len(dilations)))

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations[::2], self.activations[1::2]):
            x = x + c2(a2(c1(a1(x))))
        return x


class BigVGANGenerator(nn.Module):
    def __init__(self, cfg: BigVGANConfig):
        super().__init__()
        if cfg.resblock != "1" or cfg.activation != "snakebeta":
            raise ValueError(f"the port's BigVGAN takes AMPBlock1 with snakebeta, got resblock={cfg.resblock!r}, "
                             f"activation={cfg.activation!r}")
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _Conv(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList(nn.ModuleList([_ConvTranspose(c0 // 2**i, c0 // 2 ** (i + 1), k, u)])
                                 for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            AMPBlock1(c0 // 2 ** (i + 1), k, dils, cfg.snake_logscale)
            for i in range(len(cfg.upsample_rates))
            for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        c_last = c0 // 2 ** len(cfg.upsample_rates)
        self.activation_post = Activation1d(c_last, cfg.snake_logscale)
        self.conv_post = _Conv(c_last, 1, 7, bias=cfg.use_bias_at_final)

    def forward(self, mel, compute_dtype=None, mrf_impl: str = "kernel"):
        """[B, T, num_mels] -> [B, T * total_upsampling] f32 waveform."""
        if mrf_impl not in ("kernel", "plain"):
            raise ValueError(f"mrf_impl must be 'kernel' or 'plain', got {mrf_impl!r}")
        with span("bigvgan.generator", device=True):
            x = mel if compute_dtype is None else mel.to(compute_dtype)
            x = self.conv_pre(x.transpose(1, 2))
            n_k = len(self.cfg.resblock_kernel_sizes)
            for i, up in enumerate(self.ups):
                x = up[0](x)
                xs = None
                for block in self.resblocks[i * n_k:(i + 1) * n_k]:
                    xs = block(x) if xs is None else xs + block(x)
                x = xs / n_k
            x = self.conv_post(self.activation_post(x))
            x = torch.tanh(x) if self.cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
            return x[:, 0].float()
