"""HiFi-GAN generator, mel -> waveform: ResBlock1 (V1) or ResBlock2 (V2/V3).

Counterpart of `efficient_tts_tpu/models/hifigan.py:generator` in the plain
form it is proven equal to (`pack_small_channels=False`,
`ups_impl="dilated"`): conv_pre k7, then per upsample leaky 0.1 ->
transposed conv (padding (k-u)//2) -> MRF stage, then leaky 0.01 ->
conv_post k7 -> tanh in f32. ResBlock1 stages run through `ops/mrf.py`:
on the card, the Hopper kernel of the activations' dtype (bf16, or f32
when `compute_dtype` is None, the default), at any width up to 256
channels (a width that is not a multiple of 32 zero-padded to the next
one), and the plain version above 256, as the JAX generator leaves such
stages to XLA. ResBlock2 stages (`ResBlock2Stage`) are plain convs: the
JAX package's Pallas path hosts ResBlock1 stages only. `generator_chunked`
vocodes a long mel in overlapping windows. The TPU's
space-to-depth packing, subpixel/phase strategies and serving tables
are re-layouts for the TPU and are not carried over.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch import nn

from efficient_tts_tpu_torch.nn.layers import Conv1d, ConvTranspose1d, leaky_relu
from efficient_tts_tpu_torch.ops.mrf import (conv_order, kernel_channels, kernel_weights, mrf_stage_any_width,
                                             mrf_stage_reference, true_div)
from efficient_tts_tpu_torch.utils.device import check_module_device, resolve_device
from efficient_tts_tpu_torch.utils.precision import full_f32
from efficient_tts_tpu_torch.utils.profiling import span

LRELU_SLOPE = 0.1
# `MRFStage.kernel_weights` looks up and makes its cache entry under this
# lock, so threads that serve one generator make a stage's TMA descriptors once
_KERNEL_WEIGHTS_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """Same fields and defaults as the JAX package's `HiFiGANConfig` (V1)."""

    resblock: str = "1"
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050
    segment_size: int = 8192
    hop_size: int = 256

    @property
    def total_upsampling(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


class MRFStage(nn.Module):
    """The weights of one MRF stage in the kernels' layout: every conv's
    [k, C_out, C_in] weight back to back in one flat f32 buffer, a bf16 copy
    made once at load time, and f32 biases [n_convs, C]. On the card each
    dtype's `KernelWeights` (the bf16 views, or the f32 weights' TF32 split,
    with their TMA descriptors; at a width that is not a multiple of 32, of
    the weights and biases zero-padded to the next one) is made on first use
    and kept until the weights or biases move or change. A stage wider than
    256 channels runs the plain version (`ops/mrf.py:mrf_stage_any_width`)."""

    def __init__(self, channels: int, kernel_sizes, dilation_sizes):
        super().__init__()
        self.channels = channels
        self.kernel_sizes = tuple(kernel_sizes)
        self.dilation_sizes = tuple(tuple(d) for d in dilation_sizes)
        self.shapes = [(k, channels, channels) for k, _ in conv_order(kernel_sizes, dilation_sizes)]
        n = sum(k * channels * channels for k, _, _ in self.shapes)
        self.register_buffer("weight", torch.zeros(n))
        self.register_buffer("weight_bf16", torch.zeros(n, dtype=torch.bfloat16))
        self.register_buffer("bias", torch.zeros(len(self.shapes), channels))
        self._kernel_weights = {}

    @torch.no_grad()
    def load(self, weights, biases) -> None:
        """weights: per conv [k, C_out, C_in]; biases [n_convs, C]."""
        flat = torch.cat([torch.from_numpy(np.array(w, np.float32)).reshape(-1) for w in weights])
        self.weight.copy_(flat)
        self.weight_bf16.copy_(self.weight.to(torch.bfloat16))
        self.bias.copy_(torch.from_numpy(np.array(biases, np.float32)))

    def conv_weights(self, dtype) -> list:
        flat = self.weight_bf16 if dtype == torch.bfloat16 else self.weight.to(dtype)
        return [w.view(s) for w, s in zip(flat.split([k * a * b for k, a, b in self.shapes]), self.shapes)]

    def kernel_weights(self, dtype):
        """The stage's `KernelWeights` for `dtype` (padded with the biases when
        the width is not a multiple of 32), made again whenever the weights'
        or the biases' buffer moves or changes in place (`load`,
        `load_state_dict` and `copy_` each bump its version counter)."""
        with _KERNEL_WEIGHTS_LOCK:
            ws = self.conv_weights(dtype)
            key = (dtype, ws[0].device, ws[0].data_ptr(), ws[0]._version, self.bias.data_ptr(), self.bias._version)
            kw = self._kernel_weights.get(dtype)
            if kw is None or kw[0] != key:
                kw = self._kernel_weights[dtype] = (key, kernel_weights(ws, self.bias))
            return kw[1]

    def forward(self, x, impl: str = "kernel"):
        if impl == "plain":
            return mrf_stage_reference(x, self.conv_weights(x.dtype), self.bias, self.kernel_sizes,
                                       self.dilation_sizes)
        _check_impl(impl)
        on_kernel = x.device.type == "cuda" and kernel_channels(self.channels) is not None
        ws = self.kernel_weights(x.dtype) if on_kernel else self.conv_weights(x.dtype)
        return mrf_stage_any_width(x, ws, self.bias, self.kernel_sizes, self.dilation_sizes)


def _check_impl(impl: str) -> None:
    if impl not in ("kernel", "plain"):
        raise ValueError(f"mrf_impl must be 'kernel' or 'plain', got {impl!r}")


class ResBlock2Stage(nn.Module):
    """One MRF stage of ResBlock2 branches (`hifigan.py:_resblock2`): per
    branch, for each dilation d, x = x + conv_d(leaky(x)) with one dilated
    conv; the stage is the mean of its branches. No kernel hosts it, so
    `mrf_impl` has nothing to choose here."""

    def __init__(self, channels: int, kernel_sizes, dilation_sizes):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.ModuleList(Conv1d(channels, channels, k, d) for d in dils)
            for k, dils in zip(kernel_sizes, dilation_sizes))

    def forward(self, x, impl: str = "kernel"):
        _check_impl(impl)
        out = None
        for branch in self.convs:
            xb = x
            for conv in branch:
                xb = conv(leaky_relu(xb, LRELU_SLOPE)) + xb
            out = xb if out is None else out + xb
        return true_div(out, float(len(self.convs)))


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', got {cfg.resblock!r}")
        stage_cls = MRFStage if cfg.resblock == "1" else ResBlock2Stage
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList()
        self.stages = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = c0 // 2**i, c0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(cin, cout, k, u, (k - u) // 2))
            self.stages.append(stage_cls(cout, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        self.conv_post = Conv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7)

    def forward(self, mel, compute_dtype=None, mrf_impl: str = "kernel"):
        """[B, T, num_mels] -> [B, T * total_upsampling] f32 waveform.
        `mrf_impl="plain"` runs the MRF stages' plain PyTorch version."""
        with span("hifigan.generator", device=True):
            x = mel if compute_dtype is None else mel.to(compute_dtype)
            x = self.conv_pre(x)
            for up, stage in zip(self.ups, self.stages):
                x = up(leaky_relu(x, LRELU_SLOPE))
                x = stage(x.contiguous(), mrf_impl)
            # the reference's F.leaky_relu before conv_post uses torch's default 0.01
            x = self.conv_post(leaky_relu(x, 0.01))
            return torch.tanh(x.float())[..., 0]


def require_v1_overlap(voc, what: str) -> None:
    """Raise unless `voc` is a HiFi-GAN generator: `what` cuts the mel into
    windows whose overlap is sized for V1's receptive field, about 14 mel
    frames a side, and would stitch another generator (BigVGAN's reaches
    further) wrong."""
    if not isinstance(voc, HiFiGANGenerator):
        raise TypeError(f"{what} sizes its overlap for HiFi-GAN V1's receptive field (about 14 mel frames a "
                        f"side) and does not take a {type(voc).__name__}; vocode the whole mel in one pass")


def generator_chunked(voc: HiFiGANGenerator, mel, compute_dtype=None, mrf_impl: str = "kernel",
                      chunk_frames: int = 256, overlap_frames: int = 24, device="cuda"):
    """`hifigan.py:generator_chunked`: memory-bounded vocoding of a long mel
    [B, T, num_mels] (a tensor or an array) -> [B, T * hop] f32 on `device`
    ("cuda" by default; it raises without a card unless the caller passes
    device="cpu"). The generator's receptive field is about 14 mel frames a
    side, so windows of chunk + 2 * overlap frames, each keeping its
    interior, piece together the full pass: the first window starts at the
    true left edge and the last ends at the true right edge, so their zero
    padding is the full pass's. A mel of at most chunk + 2 * overlap frames
    takes one full pass. f32 convolutions run without TF32. Another
    generator than HiFi-GAN's raises (`require_v1_overlap`)."""
    require_v1_overlap(voc, "generator_chunked")
    dev = resolve_device(device)
    check_module_device(voc, dev)
    mel = torch.as_tensor(mel, device=dev)
    t, hop, ov = mel.shape[1], voc.cfg.total_upsampling, overlap_frames
    kw = dict(compute_dtype=compute_dtype, mrf_impl=mrf_impl)
    with full_f32(), torch.inference_mode():
        if t <= chunk_frames + 2 * ov:
            return voc(mel, **kw)
        n_chunks = -(-t // chunk_frames)
        pieces = []
        for i in range(n_chunks):
            lo, hi = i * chunk_frames, min(t, (i + 1) * chunk_frames)
            if i == 0:
                seg, keep_lo = mel[:, : chunk_frames + ov], 0
            elif i == n_chunks - 1:
                seg, keep_lo = mel[:, t - (chunk_frames + ov):], chunk_frames + ov - (hi - lo)
            else:
                seg, keep_lo = mel[:, lo - ov: hi + ov], ov
            wav = voc(seg.contiguous(), **kw)
            pieces.append(wav[:, keep_lo * hop: (keep_lo + hi - lo) * hop])
        return torch.cat(pieces, dim=1)
