"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

Counterpart of the forward of JAX's library Pallas TPU flash attention
(`jax/experimental/pallas/ops/tpu/flash_attention.py:flash_attention`,
forward `pallas_call`), which `efficient_tts_tpu/nn/attention.py:
_flash_attention` calls. Per (batch, head):

    o = softmax(q k^T * sm_scale + where(seg_q == seg_k, 0, MASK_VALUE)) v

with the scale applied after the product, MASK_VALUE = -0.7 * f32 max (a
finite value, so a row whose keys are all in other segments does not give
NaN), no mask term without segment ids, an f32 softmax and the library's
l == 0 guard. Tensors are [B, H, T, dk] f32; the kernel takes any strides
with a unit last stride, so the [B, T, H, dk] views that come out of the
q/k/v linears go in without a copy, and it writes o as a [B, H, T, dk]
view of a contiguous [B, T, H, dk] buffer, which reshapes to [B, T, H*dk]
without a copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

# the library's DEFAULT_MASK_VALUE as f32 sees it
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
# launches of the CUDA kernel, keyed by whether the call had segment ids;
# only `flash_attention` adds
launches: dict[bool, int] = {}


class SegmentIds(NamedTuple):
    """int32 segment ids, q [B, Tq] and kv [B, Tk]; a query attends only to
    keys of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


def reset_launches() -> None:
    launches.clear()


def flash_attention_reference(q, k, v, segment_ids: SegmentIds | None = None, sm_scale: float = 1.0):
    """Plain PyTorch version, in f32, with the kernel's scale order, mask
    value and l == 0 guard (the arithmetic of `mha_reference_no_custom_vjp`)."""
    logits = torch.einsum("bhqc,bhkc->bhqk", q, k)
    if sm_scale != 1.0:
        logits = logits * sm_scale
    if segment_ids is not None:
        same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
        logits = logits + torch.where(same, 0.0, MASK_VALUE).to(logits.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    weights = p * torch.where(l == 0.0, 1.0, 1.0 / l)
    return torch.einsum("bhqk,bhkc->bhqc", weights, v)


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        # q, k, v, seg_q, seg_kv, o; B, H, Tq, Tk, dk; (b, h, t) strides of q, k, v, o
        lib.flash_attention_fwd.argtypes = [p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [f, f, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, segment_ids):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes f32 {name}, got {x.dtype}")
        if x.dim() != 4 or x.device != q.device:
            raise ValueError(f"flash_attention kernel takes [B, H, T, dk] {name} on {q.device}")
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} with a unit last stride, the other "
                             f"strides multiples of 4 and 16-byte alignment; got strides {x.stride()}")
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, dk) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if dk % 8 or not 8 <= dk <= 128 or tq % 64 or tk % 64 or tq < 64 or tk < 64:
        raise ValueError(f"flash_attention kernel needs dk a multiple of 8 up to 128 and Tq, Tk "
                         f"multiples of 64; got dk={dk}, Tq={tq}, Tk={tk}")
    if segment_ids is not None:
        for ids, t in ((segment_ids.q, tq), (segment_ids.kv, tk)):
            if (ids.dtype != torch.int32 or tuple(ids.shape) != (b, t) or not ids.is_contiguous()
                    or ids.device != q.device):
                raise ValueError(f"segment ids must be contiguous int32 [{b}, {t}] on {q.device}")


def flash_attention(q, k, v, segment_ids: SegmentIds | None = None, sm_scale: float = 1.0):
    """q [B, H, Tq, dk], k/v [B, H, Tk, dk] -> o [B, H, Tq, dk]. A CPU tensor
    goes through `flash_attention_reference`; a CUDA tensor through the
    Hopper kernel (one launch), or it raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, segment_ids, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k, v, segment_ids)
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    out = torch.empty((b, tq, h, dk), device=q.device, dtype=torch.float32).transpose(1, 2)
    seg_q = segment_ids.q.data_ptr() if segment_ids is not None else None
    seg_kv = segment_ids.kv.data_ptr() if segment_ids is not None else None
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q, seg_kv, out.data_ptr(),
            b, h, tq, tk, dk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), MASK_VALUE, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    key = segment_ids is not None
    launches[key] = launches.get(key, 0) + 1
    return out
