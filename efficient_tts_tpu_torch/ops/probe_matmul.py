"""Matmul rate probe: the Hopper kernel's wrapper and its plain version.

Counterpart of the TPU probe `scripts/probe_int8_pallas.py:make` (its
`pallas_call` over the `kernel` body): out = x @ w applied `repeat` times,
x [M, 128], w [128, 128] ([K, N]), in

  bf16: f32 accumulation, rounded to bf16 between repeats and at the end;
  int8: int32 accumulation, then int8 by keeping the low 8 bits between
        repeats and at the end, as a cast to int8 wraps (300 -> 44).

The probe measured the ratio of the int8 and bf16 matrix rates; on the card
`bench/probe_int8.py` times it beside the library's chains. The card's
kernel (`csrc/probe_matmul.cu`) is a wgmma kernel fed by TMA: a persistent
block per SM, 64-row tiles of x landed into a ring, the first product read
from shared memory and the next ones from the accumulator registers.
"""

from __future__ import annotations

import ctypes

import torch

from efficient_tts_tpu_torch.ops import launch_counts
from efficient_tts_tpu_torch.utils.precision import full_f32

K = 128
_MODES = {torch.bfloat16: ("bf16", 0), torch.int8: ("int8", 1)}
# kernel launches by mode ("bf16" or "int8"); only `probe_matmul` adds
launches: dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


def wrap_int8(v):
    """Integer tensor -> int8 holding its low 8 bits (two's complement)."""
    return (((v.to(torch.int32) + 128) & 255) - 128).to(torch.int8)


def probe_matmul_reference(x, w, repeat: int = 8):
    """Plain version. The products run in f32 without TF32: bf16 products
    are exact in f32 and summed there; in int8 a sum of 128 products of
    magnitude at most 127^2 is an integer below 2^24, exact in f32."""
    with full_f32():
        wf, acc = w.float(), x
        for _ in range(repeat):
            y = acc.float() @ wf
            acc = wrap_int8(y.to(torch.int32)) if x.dtype == torch.int8 else y.to(torch.bfloat16)
    return acc


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("probe_matmul")
    if lib.probe_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_matmul.argtypes = [p, p, p, i, i, i, p]
        lib.probe_matmul.restype = ctypes.c_int
    return lib


def probe_matmul(x, w, repeat: int = 8):
    """x [M, 128] and w [128, 128], both bf16 or both int8, M a multiple of
    16, contiguous and 16-byte aligned (the kernel's TMA maps need it). A
    CPU tensor goes through `probe_matmul_reference`; a CUDA tensor through
    the Hopper kernel (one launch), or it raises."""
    if x.device.type == "cpu":
        return probe_matmul_reference(x, w, repeat)
    if x.device.type != "cuda":
        raise ValueError(f"probe_matmul runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _MODES or w.dtype != x.dtype:
        raise TypeError(f"probe_matmul takes bf16 or int8 x and w of one dtype, got {x.dtype}, {w.dtype}")
    m = x.shape[0]
    if (x.dim() != 2 or x.shape[1] != K or m < 16 or m % 16 or tuple(w.shape) != (K, K)
            or not x.is_contiguous() or not w.is_contiguous() or w.device != x.device or repeat < 1
            or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"probe_matmul takes contiguous, 16-byte aligned x [M, {K}] (M a multiple of 16) "
                         f"and w [{K}, {K}] on one device, got {tuple(x.shape)}, {tuple(w.shape)}")
    name, mode = _MODES[x.dtype]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        rc = _lib().probe_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, repeat, mode, stream)
    if rc != 0:
        raise RuntimeError(f"probe_matmul launch failed: CUDA error {rc}")
    launch_counts.add(launches, name)
    return out
