"""W8A8 HiFi-GAN MRF stage: the Hopper kernel's wrapper, its plain version
and its helpers.

Counterpart of `efficient_tts_tpu/ops/pallas/mrf_packed.py:mrf_stage_packed`
with int8=True, and of its `quantize_weights` and `calibrate_act_scales`, on
plain [B, T, C] bf16 activations (the TPU kernel's packed [B, T/r, r*C]
layout is a contiguous reshape of them). Each conv, in the weight order of
`ops/mrf.py:conv_order`, computes

    a = leaky(x) in bf16
    q = clip(rint(a * (127 / s)), -127, 127)          (round half to even)
    acc = the int32 sum over taps and input channels of q * wq
    y = bf16(acc * ((s / 127) * scale[co]) + bias[co])

and the stage's residual adds, branch sums and average follow in bf16 as in
`ops/mrf.py`. The activation scale s is either static, one per conv
(`act_scales` [n_convs], e.g. from `calibrate_act_scales`), or dynamic:
max |a| per batch element over all of [0, T), at least 1e-12. The dynamic
scale is `mrf_stage_packed_reference`'s, and the TPU kernel's per-(batch,
tile) scale whenever the sequence fits one of its tiles; past one tile the
TPU kernel's result depends on its tile size, and this one's does not.

On the card the int8 weights go in with their TMA descriptors
(`kernel_weights(wq)`, an `ops/mrf.py:KernelWeights`), made once per
weight; a plain list of weights is prepared at each call.

This is an op, not a generator option: the generator never quantizes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.nn.layers import leaky_relu
from efficient_tts_tpu_torch.ops import launch_counts
from efficient_tts_tpu_torch.ops.mrf import (LRELU_SLOPE, KernelWeights, check_stage, conv_plain, stage_chain,
                                             stage_launches, true_div)

# launches of the CUDA kernels, keyed by (kind, channels): kind "dynamic" or
# "static" for a conv launch (18 per V1 stage), "absmax" for the reduction
# at a dynamic-scale stage's entry; only `mrf_stage_int8` adds
launches: dict[tuple[str, int], int] = {}


def reset_launches() -> None:
    launches.clear()


def quantize_weights(weights):
    """Per-output-channel symmetric int8 weights, one scale vector per conv.

    weights: per conv [k, C_out, C_in] (f32, or bf16 values taken as f32).
    s[co] = max(max over taps and input channels of |w|, 1e-12) / 127 and
    wq = clip(round(w / s), -127, 127). The JAX package quantizes the packed
    weight per output lane (i, co); that weight scatters w, so every lane
    (i, co) sees all taps and input channels of co and holds this s.
    Returns (wq: list of int8 [k, C, C], scales: f32 [n_convs, C])."""
    wq, scales = [], []
    for w in weights:
        w = w.float()
        s = true_div(torch.clamp_min(w.abs().amax(dim=(0, 2)), 1e-12), 127.0)
        wq.append(torch.clamp(torch.round(w / s[None, :, None]), -127, 127).to(torch.int8).contiguous())
        scales.append(s)
    return wq, torch.stack(scales)


def calibrate_act_scales(x, weights, biases, kernel_sizes, dilation_sizes):
    """Static activation scales from a calibration batch: for every conv,
    max |leaky(its input)| over the whole batch, at least 1e-12, through the
    plain bf16 stage (`mrf_stage_reference`'s arithmetic). x [B, T, C];
    weights per conv [k, C_out, C_in]; biases [n_convs, C]. Returns f32
    [n_convs] on x's device."""
    seen = []

    def conv(a, i, d):
        seen.append(leaky_relu(a, LRELU_SLOPE).float().abs().amax())
        return conv_plain(a, weights[i], biases[i], d, torch.bfloat16)

    stage_chain(x.to(torch.bfloat16), conv, dilation_sizes)
    return torch.clamp_min(torch.stack(seen), 1e-12)


def conv_int8_plain(a, wq, scale, bias, d, s):
    """One W8A8 conv of bf16 a [B, T, C] with activation scale s (f32, a
    scalar or [B, 1, 1]), leaky included; returns bf16 [B, T, C]. The int32
    sum is taken in f64, where every partial sum of integers below 2^53 is
    exact."""
    k = wq.shape[0]
    q = torch.clamp(torch.round(leaky_relu(a, LRELU_SLOPE).float() * true_div(127.0, s)), -127, 127)
    acc = F.conv1d(q.double().transpose(1, 2), wq.double().permute(1, 2, 0), padding=(k - 1) // 2 * d, dilation=d)
    y = acc.transpose(1, 2).float() * (true_div(s, 127.0) * scale)
    return (y + bias).to(torch.bfloat16)


def dynamic_scale(a):
    """max |leaky(a)| per batch element, at least 1e-12: f32 [B, 1, 1]."""
    return torch.clamp_min(leaky_relu(a, LRELU_SLOPE).float().abs().amax(dim=(1, 2), keepdim=True), 1e-12)


def mrf_stage_int8_reference(x, wq, scales, biases, kernel_sizes, dilation_sizes, act_scales=None):
    """Plain PyTorch version of the W8A8 stage. x [B, T, C] bf16; wq per conv
    int8 [k, C_out, C_in]; scales and biases f32 [n_convs, C]; act_scales
    f32 [n_convs] or None for dynamic scales. Returns bf16 [B, T, C]."""

    def conv(a, i, d):
        s = dynamic_scale(a) if act_scales is None else act_scales[i]
        return conv_int8_plain(a, wq[i], scales[i], biases[i], d, s)

    return stage_chain(x, conv, dilation_sizes)


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("mrf_stage_int8")
    if lib.mrf_conv_int8.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mrf_conv_int8.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f, p]
        lib.mrf_conv_int8.restype = ctypes.c_int
        lib.mrf_absmax.argtypes = [p, p, i, i, i, f, p]
        lib.mrf_absmax.restype = ctypes.c_int
        lib.mrf_int8_weight_map.argtypes = [p, p, i, i]
        lib.mrf_int8_weight_map.restype = ctypes.c_int
    return lib


def kernel_weights(wq) -> KernelWeights:
    """The int8 weights (one contiguous [k, C, C] tensor per conv, as
    `quantize_weights` gives them) with, on a CUDA device, each conv's
    128-byte TMA descriptor (boxes of 32 bytes of input channels x C output
    channels). It holds the weight's address: make it once per weight, not
    in a timed loop. On the CPU `maps` stays None."""
    wq = list(wq)
    kw = KernelWeights(wq, wq)
    if wq and wq[0].device.type == "cuda":
        lib = _lib()
        kw.maps = []
        for w in wq:
            k, c = w.shape[0], w.shape[-1]
            if (w.dtype != torch.int8 or not w.is_contiguous() or tuple(w.shape) != (k, c, c)
                    or w.data_ptr() % 16):
                raise ValueError(f"an int8 kernel weight must be contiguous int8 [k, {c}, {c}], 16-byte aligned")
            buf = ctypes.create_string_buffer(128)
            rc = lib.mrf_int8_weight_map(buf, w.data_ptr(), k, c)
            if rc != 0:
                raise RuntimeError(f"mrf_int8_weight_map failed: CUDA error {rc}")
            kw.maps.append(buf)
    return kw


def _check(x, wq, scales, biases, kernel_sizes, dilation_sizes, act_scales):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mrf_stage_int8 takes bf16 activations, got {x.dtype}")
    check_stage(x, wq, biases, kernel_sizes, dilation_sizes, torch.int8)
    if (scales.dtype != torch.float32 or tuple(scales.shape) != tuple(biases.shape)
            or scales.device != x.device or not scales.is_contiguous()):
        raise TypeError(f"scales must be contiguous f32 {tuple(biases.shape)} on the activations' device")
    if act_scales is not None and (act_scales.dtype != torch.float32 or tuple(act_scales.shape) != (len(wq),)
                                   or act_scales.device != x.device or not act_scales.is_contiguous()):
        raise TypeError(f"act_scales must be contiguous f32 [{len(wq)}] on the activations' device")


def mrf_stage_int8(x, wq, scales, biases, kernel_sizes, dilation_sizes, act_scales=None):
    """One W8A8 MRF stage. `wq` is `kernel_weights(wq)` or the list of int8
    [k, C, C] weights. A CPU tensor goes through `mrf_stage_int8_reference`;
    a CUDA tensor through the Hopper kernel (s8 wgmma with int32 sums, the
    weights by TMA; 18 launches for V1, plus one absmax launch at the entry
    with dynamic scales), or it raises. Given a list on the card, the TMA
    descriptors are made here, at every call."""
    kw = wq if isinstance(wq, KernelWeights) else None
    wq = wq if kw is None else kw.weights
    if x.device.type == "cpu":
        return mrf_stage_int8_reference(x, wq, scales, biases, kernel_sizes, dilation_sizes, act_scales)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_int8 runs on cpu or cuda tensors, got {x.device}")
    _check(x, wq, scales, biases, kernel_sizes, dilation_sizes, act_scales)
    if kw is None or kw.maps is None:
        kw = kernel_weights(wq)
    lib = _lib()
    b, t, c = x.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    slope = torch.tensor(LRELU_SLOPE, dtype=torch.bfloat16).item()
    dynamic = act_scales is None
    kind = "dynamic" if dynamic else "static"

    with torch.cuda.device(x.device):
        # dynamic scales: one row of per-batch-element absmax for the stage's
        # input and one for each conv's output, each written once by atomicMax
        # over a floor of 1e-12; a conv reads the row of the tensor it reads
        amax = torch.full((len(wq) + 1, b), 1e-12, device=x.device) if dynamic else None
        row_of = {}
        if dynamic:
            rc = lib.mrf_absmax(x.data_ptr(), amax[0].data_ptr(), b, t, c, slope, stream)
            if rc != 0:
                raise RuntimeError(f"mrf_absmax launch failed: CUDA error {rc}")
            launch_counts.add(launches, ("absmax", c))
            row_of[x.data_ptr()] = 0

        def launch(src, i, d, res, dst, flags):
            if dynamic:
                s_in, s_stride, amax_out = amax[row_of[src.data_ptr()]].data_ptr(), 1, amax[i + 1].data_ptr()
                row_of[dst.data_ptr()] = i + 1
            else:
                s_in, s_stride, amax_out = act_scales[i].data_ptr(), 0, None
            rc = lib.mrf_conv_int8(kw.maps[i], src.data_ptr(), scales[i].data_ptr(), biases[i].data_ptr(),
                                   res.data_ptr() if res is not None else None, dst.data_ptr(), s_in, s_stride,
                                   amax_out, b, t, c, wq[i].shape[0], d, flags, len(kernel_sizes), slope, stream)
            if rc != 0:
                raise RuntimeError(f"mrf_conv_int8 launch failed: CUDA error {rc}")
            launch_counts.add(launches, (kind, c))

        return stage_launches(x, len(kernel_sizes), dilation_sizes, launch)
