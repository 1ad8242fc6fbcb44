"""HiFi-GAN MRF stage: the Hopper kernels' wrapper and its plain version.

An MRF stage is the average of len(kernel_sizes) ResBlock1 branches; a
branch is, per dilation d, x + conv_1(leaky(conv_d(leaky(x)))), with leaky
slope 0.1 and zero padding at the ends of [0, T). Counterpart of the TPU
kernels `efficient_tts_tpu/ops/pallas/mrf_packed.py:mrf_stage_packed`
(bf16 mode) and `ops/pallas/mrf.py:mrf_stage` (bf16 and f32).

Activations are bf16 or f32, with weights of the same dtype. Weights are
one [k, C_out, C_in] tensor per conv, in the order branch by branch, per
dilation the dilated conv then the d=1 conv (the order of
`mrf_packed.stage_plan`); biases are f32 [n_convs, C]. Values are rounded
to the activation dtype after each conv's bias, each residual add, each
partial branch sum and the final / n_kernels, where the Pallas kernels
round (in f32 those roundings are no-ops).

On the card the weights go in as `KernelWeights` only: the kernel's layout
of each conv (bf16 as it is; f32 split into TF32 hi and lo, [2, k, C_out,
C_in], for the 3xTF32 products) and its TMA descriptor, made once per
weight (`kernel_weights`). `models/hifigan.py:MRFStage` caches its own.

The kernels take C a multiple of 32 up to 256 (`mrf_stage`). A generator
stage of any other width goes through `mrf_stage_any_width`: up to 256
channels it runs the kernel at Cp = `kernel_channels(C)`, its weights and
biases zero-padded once (`kernel_weights(ws, biases)`) and its activations
per call, the result sliced back to C. That is exact in bf16 and in f32:
the padded channels see only zero weights and biases, so they stay 0
through every conv, leaky, residual and the average, and add only exact
zeros to the real channels' sums. Above 256 channels, where the JAX
generator leaves a stage to XLA, the stage takes `mrf_stage_reference`,
counted in `launches` under ("plain", C).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from efficient_tts_tpu_torch.nn.layers import leaky_relu
from efficient_tts_tpu_torch.ops import launch_counts

LRELU_SLOPE = 0.1
# the kernels take C a multiple of CHANNEL_STEP up to MAX_KERNEL_CHANNELS
MAX_KERNEL_CHANNELS, CHANNEL_STEP = 256, 32
# conv launches of the CUDA kernels, by (dtype name, channels the kernel ran
# at); only `mrf_stage` adds. `mrf_stage_any_width` adds ("plain", C) once for
# each card stage too wide for the kernels. Added to under a lock
# (`launch_counts.add`): the serving engine launches from several threads.
launches: dict[tuple[str, int], int] = {}

_RESIDUAL, _ADD_SUM, _AVERAGE = 1, 2, 4
# the kernel entry point for each activation dtype
_ENTRY = {torch.bfloat16: ("bf16", "mrf_conv"), torch.float32: ("f32", "mrf_conv_f32")}


def reset_launches() -> None:
    launches.clear()


def conv_order(kernel_sizes, dilation_sizes):
    """[(k, d)] of the stage's convs in weight order."""
    return [(k, dd) for k, dils in zip(kernel_sizes, dilation_sizes) for d in dils for dd in (d, 1)]


def true_div(a, b):
    """a / b rounded once, as the kernels divide. With a Python number on
    either side PyTorch may multiply by a rounded reciprocal instead (on the
    card whenever the divisor is a number), so the number becomes a 0-dim
    tensor on the other operand's device."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def stage_chain(x, conv, dilation_sizes):
    """The stage's dataflow around `conv(a, i, d)`, which applies conv i (in
    weight order) at dilation d to a, leaky included, and returns a tensor
    of a's dtype: per branch xb = xb + conv(conv(xb, i, d), i + 1, 1) for
    each dilation, then the average of the branches."""
    out = None
    i = 0
    for dils in dilation_sizes:
        xb = x
        for d in dils:
            y = conv(xb, i, d)
            xb = xb + conv(y, i + 1, 1)
            i += 2
        out = xb if out is None else out + xb
    return true_div(out, float(len(dilation_sizes)))


def conv_plain(a, w, b, d, dt):
    """leaky 0.1, then the conv in f32 on values of a's dtype, plus the bias,
    rounded to `dt`. a [B, T, C], w [k, C_out, C_in], b [C_out]."""
    k = w.shape[0]
    a = leaky_relu(a, LRELU_SLOPE)
    y = F.conv1d(a.float().transpose(1, 2), w.float().permute(1, 2, 0), padding=(k - 1) // 2 * d, dilation=d)
    return (y.transpose(1, 2) + b.float()).to(dt)


def mrf_stage_reference(x, weights, biases, kernel_sizes, dilation_sizes):
    """Plain PyTorch version: convs in f32 on values of x's dtype, rounded to
    x's dtype at the kernel's rounding points. x [B, T, C] -> [B, T, C]."""
    return stage_chain(x, lambda a, i, d: conv_plain(a, weights[i], biases[i], d, x.dtype), dilation_sizes)


def round_tf32(x):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as cvt.rna.tf32.f32 rounds, kept as f32 with the low 13 bits 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32x3(w):
    """An f32 weight [k, C_out, C_in] -> [2, k, C_out, C_in]: hi =
    tf32(w), then lo = tf32(w - hi), the f32 kernel's 3xTF32 operands
    (hi*lo + lo*hi + hi*hi keeps w to about 2^-22 relative)."""
    hi = round_tf32(w)
    return torch.stack([hi, round_tf32(w - hi)]).contiguous()


def kernel_channels(c: int) -> int | None:
    """The width the kernels run a C-channel stage at: C rounded up to a
    multiple of 32, or None above 256 (the plain version's stage)."""
    return -(-c // CHANNEL_STEP) * CHANNEL_STEP if c <= MAX_KERNEL_CHANNELS else None


def pad_stage(weights, biases, cp: int):
    """[k, C, C] conv weights and [n_convs, C] biases zero-padded to cp
    channels (both C_out and C_in)."""
    c = weights[0].shape[-1]
    return [F.pad(w, (0, cp - c, 0, cp - c)) for w in weights], F.pad(biases, (0, cp - c))


def pad_channels(x, cp: int):
    """[B, T, C] activations zero-padded to cp channels."""
    return F.pad(x, (0, cp - x.shape[-1]))


@dataclasses.dataclass
class KernelWeights:
    """A stage's weights as its kernel takes them, made once by
    `kernel_weights`: `weights` the [k, C, C] tensors (the plain version's),
    `kernel` their kernel layout (bf16: the same tensors; f32: the TF32
    split), and on the card `maps`, each conv's 128-byte TMA descriptor,
    which holds the address of its `kernel` tensor. A stage whose width is
    not a multiple of 32 is held padded to `kernel_channels(channels)`:
    `weights` are the padded tensors, `biases` the padded [n_convs, Cp]
    biases and `channels` the stage's own C (both None when not padded)."""

    weights: list
    kernel: list
    maps: list | None = None
    biases: torch.Tensor | None = None
    channels: int | None = None


def kernel_weights(weights, biases=None) -> KernelWeights:
    """Prepare `weights` (one [k, C, C] tensor per conv, bf16 or f32) for the
    kernels: f32 weights are split into TF32 hi and lo here. A width C up to
    256 that is not a multiple of 32 is zero-padded to `kernel_channels(C)`,
    and then the stage's f32 `biases` [n_convs, C] are needed, padded with
    it. On a CUDA device the TMA descriptors are encoded too; on the CPU
    `maps` stays None."""
    weights = list(weights)
    c = weights[0].shape[-1] if weights else 0
    cp = kernel_channels(c)
    if cp is None:
        raise ValueError(f"the MRF kernels take up to {MAX_KERNEL_CHANNELS} channels, got {c}")
    channels = None
    if weights and cp != c:
        if biases is None:
            raise ValueError(f"a {c}-channel stage runs padded to {cp}: pass its biases")
        channels = c
        weights, biases = pad_stage(weights, biases, cp)
    f32 = bool(weights) and weights[0].dtype == torch.float32
    kernel = [split_tf32x3(w) for w in weights] if f32 else weights
    kw = KernelWeights(weights, kernel, biases=biases if channels else None, channels=channels)
    if weights and weights[0].device.type == "cuda":
        lib = _lib()
        kw.maps = []
        for w, wk in zip(weights, kernel):
            k, c = w.shape[0], w.shape[-1]
            if not wk.is_contiguous() or tuple(wk.shape[-2:]) != (c, c) or wk.data_ptr() % 16:
                raise ValueError(f"kernel weight must be contiguous [..., {c}, {c}], 16-byte aligned")
            buf = ctypes.create_string_buffer(128)
            rc = lib.mrf_weight_map(buf, wk.data_ptr(), int(w.dtype == torch.float32), k, c)
            if rc != 0:
                raise RuntimeError(f"mrf_weight_map failed: CUDA error {rc}")
            kw.maps.append(buf)
    return kw


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("mrf_stage")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mrf_conv, lib.mrf_conv_f32):
        if fn.argtypes is None:
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
    if lib.mrf_weight_map.argtypes is None:
        lib.mrf_weight_map.argtypes = [p, p, i, i, i]
        lib.mrf_weight_map.restype = ctypes.c_int
    return lib


def check_stage(x, weights, biases, kernel_sizes, dilation_sizes, weight_dtype):
    """Raise unless x is a contiguous, 16-byte aligned [B, T, C] tensor with
    C a multiple of 32 up to 256, with one contiguous, aligned [k, C, C]
    weight of `weight_dtype` (odd k) per conv and f32 biases [n_convs, C],
    all on x's device."""
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the MRF kernels take a contiguous, 16-byte aligned [B, T, C] tensor")
    b, t, c = x.shape
    if c % 32 or c > 256 or b < 1 or t < 1:
        raise ValueError(f"the MRF kernels need C a multiple of 32 up to 256, got {tuple(x.shape)}")
    order = conv_order(kernel_sizes, dilation_sizes)
    if len(weights) != len(order) or tuple(biases.shape) != (len(order), c):
        raise ValueError(f"expected {len(order)} conv weights and biases [{len(order)}, {c}]")
    if biases.dtype != torch.float32 or biases.device != x.device or not biases.is_contiguous():
        raise TypeError("biases must be contiguous f32 on the activations' device")
    for w, (k, _) in zip(weights, order):
        if w.dtype != weight_dtype:
            raise TypeError(f"conv weights must be {weight_dtype} here, got {w.dtype}")
        if tuple(w.shape) != (k, c, c) or w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"conv weight must be contiguous [{k}, {c}, {c}] on {x.device}, 16-byte aligned")
        if k % 2 == 0:
            raise ValueError(f"kernel size {k}: odd sizes only")


def _check(x, weights, biases, kernel_sizes, dilation_sizes):
    if x.dtype not in _ENTRY:
        raise TypeError(f"mrf_stage takes bf16 or f32 activations, got {x.dtype}")
    check_stage(x, weights, biases, kernel_sizes, dilation_sizes, x.dtype)


def stage_launches(x, n_branches, dilation_sizes, launch):
    """Launch the stage's convs: `launch(src, i, d, res, dst, flags)` for each
    conv i, into the scratch `tmp` and `xb` and the result, which it returns.
    A branch's last conv adds into the running branch sum and the last
    branch's divides it by n_branches."""
    tmp, xb, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    i = 0
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


def mrf_stage(x, weights, biases, kernel_sizes, dilation_sizes):
    """One MRF stage. `weights` is the `KernelWeights` of [k, C, C] tensors of
    x's dtype; on the CPU the list of tensors does as well. A CPU tensor goes
    through `mrf_stage_reference`; a CUDA tensor through the Hopper kernel of
    its dtype (wgmma fed by a TMA weight ring; bf16 with f32 accumulation,
    f32 as 3xTF32 products), 18 launches for V1, or it raises."""
    kw = weights if isinstance(weights, KernelWeights) else None
    if x.device.type == "cpu":
        return mrf_stage_reference(x, weights if kw is None else kw.weights, biases, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cpu or cuda tensors, got {x.device}")
    if kw is None or kw.maps is None:
        raise TypeError("on the card mrf_stage takes `kernel_weights(weights)` made from CUDA tensors")
    weights = kw.weights
    _check(x, weights, biases, kernel_sizes, dilation_sizes)
    name, entry = _ENTRY[x.dtype]
    fn = getattr(_lib(), entry)
    b, t, c = x.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    slope = torch.tensor(LRELU_SLOPE, dtype=x.dtype).item()
    n_branches = len(kernel_sizes)

    def launch(src, i, d, res, dst, flags):
        rc = fn(kw.maps[i], src.data_ptr(), biases[i].data_ptr(), res.data_ptr() if res is not None else None,
                dst.data_ptr(), b, t, c, weights[i].shape[0], d, flags, n_branches, slope, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
        launch_counts.add(launches, (name, c))

    with torch.cuda.device(x.device):
        return stage_launches(x, n_branches, dilation_sizes, launch)


def mrf_stage_any_width(x, weights, biases, kernel_sizes, dilation_sizes):
    """One MRF stage of any width, as the generator runs it. A CPU tensor goes
    through `mrf_stage_reference`. On the card, a stage of C up to 256 takes
    the kernel: `weights` is `kernel_weights(ws, biases)`, and when it is
    padded (C not a multiple of 32) x is zero-padded to its width, the
    padded biases are used and the result is sliced back to C. A stage wider
    than 256 (`weights` the [k, C, C] tensors) takes `mrf_stage_reference`,
    counted as ("plain", C), before any launch."""
    c = x.shape[-1]
    if x.device.type == "cuda" and kernel_channels(c) is None:
        launch_counts.add(launches, ("plain", c))
        return mrf_stage_reference(x, weights, biases, kernel_sizes, dilation_sizes)
    if isinstance(weights, KernelWeights) and weights.channels is not None:
        if weights.channels != c:
            raise ValueError(f"weights padded from {weights.channels} channels, activations have {c}")
        cp = weights.weights[0].shape[-1]
        return mrf_stage(pad_channels(x, cp), weights, weights.biases, kernel_sizes, dilation_sizes)[..., :c]
    return mrf_stage(x, weights, biases, kernel_sizes, dilation_sizes)
