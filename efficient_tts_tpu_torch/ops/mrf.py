"""HiFi-GAN MRF stage: the Hopper kernel's wrapper and its plain version.

An MRF stage is the average of len(kernel_sizes) ResBlock1 branches; a
branch is, per dilation d, x + conv_1(leaky(conv_d(leaky(x)))), with leaky
slope 0.1 and zero padding at the ends of [0, T). Counterpart of the TPU
kernels `efficient_tts_tpu/ops/pallas/mrf_packed.py:mrf_stage_packed`
(bf16 mode) and `ops/pallas/mrf.py:mrf_stage`.

Weights are in the kernel's layout: one [k, C_out, C_in] tensor per conv,
in the order branch by branch, per dilation the dilated conv then the d=1
conv (the order of `mrf_packed.stage_plan`); biases are f32 [n_convs, C].
Values are rounded to the activation dtype after each conv's bias, each
residual add, each partial branch sum and the final / n_kernels, where the
Pallas kernel rounds.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.nn.layers import leaky_relu

LRELU_SLOPE = 0.1
# conv launches of the CUDA kernel, by channel count; only `mrf_stage` adds
launches: dict[int, int] = {}

_RESIDUAL, _ADD_SUM, _AVERAGE = 1, 2, 4


def reset_launches() -> None:
    launches.clear()


def conv_order(kernel_sizes, dilation_sizes):
    """[(k, d)] of the stage's convs in weight order."""
    return [(k, dd) for k, dils in zip(kernel_sizes, dilation_sizes) for d in dils for dd in (d, 1)]


def mrf_stage_reference(x, weights, biases, kernel_sizes, dilation_sizes):
    """Plain PyTorch version: convs in f32 on values of x's dtype, rounded to
    x's dtype at the kernel's rounding points. x [B, T, C] -> [B, T, C]."""
    dt = x.dtype

    def conv(a, w, b, d):
        k = w.shape[0]
        a = leaky_relu(a, LRELU_SLOPE)
        y = F.conv1d(a.float().transpose(1, 2), w.float().permute(1, 2, 0),
                     padding=(k - 1) // 2 * d, dilation=d)
        return (y.transpose(1, 2) + b.float()).to(dt)

    out = None
    i = 0
    for dils in dilation_sizes:
        xb = x
        for d in dils:
            y = conv(xb, weights[i], biases[i], d)
            xb = xb + conv(y, weights[i + 1], biases[i + 1], 1)
            i += 2
        out = xb if out is None else out + xb
    return out / len(kernel_sizes)


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("mrf_stage")
    if lib.mrf_conv.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.mrf_conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.mrf_conv.restype = ctypes.c_int
    return lib


def _check(x, weights, biases, kernel_sizes, dilation_sizes):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mrf_stage kernel takes bf16 activations, got {x.dtype} "
                        "(on the card, synthesize with compute_dtype=torch.bfloat16)")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mrf_stage kernel takes a contiguous, 16-byte aligned [B, T, C] tensor")
    b, t, c = x.shape
    if c % 32 or c > 256 or b < 1 or t < 1:
        raise ValueError(f"mrf_stage kernel needs C a multiple of 32 up to 256, got {tuple(x.shape)}")
    order = conv_order(kernel_sizes, dilation_sizes)
    if len(weights) != len(order) or tuple(biases.shape) != (len(order), c):
        raise ValueError(f"expected {len(order)} conv weights and biases [{len(order)}, {c}]")
    if biases.dtype != torch.float32 or biases.device != x.device or not biases.is_contiguous():
        raise TypeError("biases must be contiguous f32 on the activations' device")
    for w, (k, _) in zip(weights, order):
        if (tuple(w.shape) != (k, c, c) or w.dtype != torch.bfloat16 or w.device != x.device
                or not w.is_contiguous() or w.data_ptr() % 16):
            raise ValueError(f"conv weight must be contiguous bf16 [{k}, {c}, {c}] on {x.device}")
        if k % 2 == 0:
            raise ValueError(f"kernel size {k}: odd sizes only")


def mrf_stage(x, weights, biases, kernel_sizes, dilation_sizes):
    """One MRF stage. A CPU tensor goes through `mrf_stage_reference`; a CUDA
    tensor through the Hopper kernel (18 launches for V1), or it raises."""
    if x.device.type == "cpu":
        return mrf_stage_reference(x, weights, biases, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cpu or cuda tensors, got {x.device}")
    _check(x, weights, biases, kernel_sizes, dilation_sizes)
    lib = _lib()
    b, t, c = x.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    slope = torch.tensor(LRELU_SLOPE, dtype=torch.bfloat16).item()
    n_branches = len(kernel_sizes)
    tmp, xb, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)

    def launch(src, i, d, res, dst, flags):
        rc = lib.mrf_conv(src.data_ptr(), weights[i].data_ptr(), biases[i].data_ptr(),
                          res.data_ptr() if res is not None else None, dst.data_ptr(),
                          b, t, c, weights[i].shape[0], d, flags, n_branches, slope, stream)
        if rc != 0:
            raise RuntimeError(f"mrf_conv launch failed: CUDA error {rc}")
        launches[c] = launches.get(c, 0) + 1

    i = 0
    with torch.cuda.device(x.device):
        for j, dils in enumerate(dilation_sizes):
            for u, d in enumerate(dils):
                src = x if u == 0 else xb
                launch(src, i, d, None, tmp, 0)
                if u == len(dils) - 1:
                    flags = _RESIDUAL | (_ADD_SUM if j > 0 else 0)
                    flags |= _AVERAGE if j == n_branches - 1 else 0
                    launch(tmp, i + 1, 1, src, out, flags)
                else:
                    launch(tmp, i + 1, 1, src, xb, _RESIDUAL)
                i += 2
    return out
