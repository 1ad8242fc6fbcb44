"""Flash attention: the Hopper kernels' wrappers and their plain versions.

Counterpart of JAX's library Pallas TPU flash attention
(`jax/experimental/pallas/ops/tpu/flash_attention.py:flash_attention`, its
forward `pallas_call` and its backward's dkv and dq `pallas_call`s), which
`efficient_tts_tpu/nn/attention.py:_flash_attention` calls. Per (batch,
head), with x = q k^T * sm_scale + where(seg_q == seg_k, 0, MASK_VALUE):

    o = softmax(x) v,  m = max(x),  l = sum(exp(x - m))
    p = exp(x - m) / l,  di = sum(o * do, -1),  ds = ((do v^T - di) p) * sm_scale
    dq = ds k,  dk = ds^T q,  dv = p^T do

with the scale applied after the product and again to ds (where the
library's kernels apply it), MASK_VALUE = -0.7 * f32 max (a finite value,
so a row whose keys are all in other segments does not give NaN), no mask
term without segment ids, and the library's l == 0 guard in the forward.
Tensors are [B, H, T, dk] f32; the kernels take any strides with a unit
last stride, so the [B, T, H, dk] views that come out of the q/k/v linears
(and the gradient that flows back into them) go in without a copy, and
they write o, dq, dk and dv as [B, H, T, dk] views of contiguous [B, T, H,
dk] buffers, which reshape to [B, T, H*dk] without a copy.

Precision on the card: every product is TF32 on the tensor cores with f32
accumulation (wgmma in all three kernels; q, k, v, do, p and ds rounded
to TF32 to nearest, ties away, before a product reads them); the scale,
mask, exp, di and every sum are f32. The plain versions here are f32
throughout. Every kernel takes its tiles by TMA through tensor maps that
its C entry encodes at each launch (3 for the forward, 4 for each
backward kernel): the operands are strided views, new at every call.

`flash_attention` is the entry point: on a CPU tensor it is the plain
forward, so autograd differentiates the plain version; on a CUDA tensor
that needs a gradient it is `FlashAttention`, whose forward kernel also
writes m and l and whose backward launches the dkv and dq kernels; on a
CUDA tensor without a gradient, the forward kernel alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from efficient_tts_tpu_torch.ops import launch_counts

# the library's DEFAULT_MASK_VALUE as f32 sees it
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
# launches of the CUDA kernels, keyed by (kernel, Tq, Tk, whether the call
# had segment ids) with kernel "fwd", "dkv" or "dq"; only the kernel wrappers add
launches: dict[tuple[str, int, int, bool], int] = {}


class SegmentIds(NamedTuple):
    """int32 segment ids, q [B, Tq] and kv [B, Tk]; a query attends only to
    keys of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


def reset_launches() -> None:
    launches.clear()


def _count(kernel: str, tq: int, tk: int, segment_ids) -> None:
    launch_counts.add(launches, (kernel, tq, tk, segment_ids is not None))


def _logits(q, k, segment_ids, sm_scale):
    logits = torch.einsum("bhqc,bhkc->bhqk", q, k)
    if sm_scale != 1.0:
        logits = logits * sm_scale
    if segment_ids is not None:
        same = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
        logits = logits + torch.where(same, 0.0, MASK_VALUE).to(logits.dtype)
    return logits


def flash_attention_reference(q, k, v, segment_ids: SegmentIds | None = None, sm_scale: float = 1.0,
                              return_residuals: bool = False):
    """Plain PyTorch version, in f32, with the kernel's scale order, mask
    value and l == 0 guard (the arithmetic of `mha_reference_no_custom_vjp`).
    With `return_residuals`, (o, m, l) with m and l [B, H, Tq]."""
    logits = _logits(q, k, segment_ids, sm_scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    weights = p * torch.where(l == 0.0, 1.0, 1.0 / l)
    o = torch.einsum("bhqk,bhkc->bhqc", weights, v)
    return (o, m[..., 0], l[..., 0]) if return_residuals else o


def flash_attention_bwd_reference(q, k, v, o, m, l, do, segment_ids: SegmentIds | None = None,
                                  sm_scale: float = 1.0):
    """Plain backward from the forward's residuals (m, l [B, H, Tq]): the
    arithmetic of the library's `mha_reference_bwd`, with the scale applied
    after the product and to ds, where its kernels apply it. Returns (dq,
    dk, dv)."""
    p = torch.exp(_logits(q, k, segment_ids, sm_scale) - m[..., None]) / l[..., None]
    dv = torch.einsum("bhqk,bhqc->bhkc", p, do)
    dp = torch.einsum("bhqc,bhkc->bhqk", do, v)
    di = torch.sum(o * do, dim=-1)[..., None]
    ds = (dp - di) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    dk = torch.einsum("bhqk,bhqc->bhkc", ds, q)
    dq = torch.einsum("bhqk,bhkc->bhqc", ds, k)
    return dq, dk, dv


def _lib():
    from efficient_tts_tpu_torch import _build

    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        # q, k, v, seg_q, seg_kv, o, m, l; B, H, Tq, Tk, dk; (b, h, t) strides of q, k, v, o
        lib.flash_attention_fwd.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_longlong] * 12 + [f, f, p]
        # q, k, v, do, m, l, di, seg_q, seg_kv, then the outputs (dk, dv or dq); B, H, Tq, Tk,
        # dk; the 21 (b, h, t) strides of q, k, v, do, dq, dk, dv
        lib.flash_attention_bwd_dkv.argtypes = [p] * 11 + [i] * 5 + [p, f, f, p]
        lib.flash_attention_bwd_dq.argtypes = [p] * 10 + [i] * 5 + [p, f, f, p]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dq):
            fn.restype = ctypes.c_int
    return lib


def _kernel_layout_ok(x) -> bool:
    st = x.stride()
    return st[-1] == 1 and not (st[0] % 4 or st[1] % 4 or st[2] % 4) and x.data_ptr() % 16 == 0


def _check(q, k, v, segment_ids):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes f32 {name}, got {x.dtype}")
        if x.dim() != 4 or x.device != q.device:
            raise ValueError(f"flash_attention kernel takes [B, H, T, dk] {name} on {q.device}")
        if not _kernel_layout_ok(x):
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


def _empty_heads(b, h, t, dk, device):
    """A [B, H, T, dk] view of a contiguous [B, T, H, dk] f32 buffer."""
    return torch.empty_strided((b, h, t, dk), (t * h * dk, dk, h * dk, 1), device=device, dtype=torch.float32)


def _seg_ptrs(segment_ids):
    if segment_ids is None:
        return None, None
    return segment_ids.q.data_ptr(), segment_ids.kv.data_ptr()


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _forward_kernel(q, k, v, segment_ids, sm_scale, residuals: bool):
    """One launch of the forward kernel: o, or (o, m, l) with `residuals`."""
    _check(q, k, v, segment_ids)
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    out = _empty_heads(b, h, tq, dk, q.device)
    m = l = None
    if residuals:
        m, l = (torch.empty((b, h, tq), device=q.device, dtype=torch.float32) for _ in range(2))
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(segment_ids), out.data_ptr(),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            b, h, tq, tk, dk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), MASK_VALUE, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention forward launch failed: CUDA error {rc}")
    _count("fwd", tq, tk, segment_ids)
    return (out, m, l) if residuals else out


def _backward_kernels(q, k, v, o, m, l, do, segment_ids, sm_scale):
    """di in PyTorch, then one launch each of the dkv and dq kernels. Their
    tiles come by TMA and bulk copies, which need 16-byte aligned rows: do
    and the segment ids are copied when they are not."""
    if do.dtype != torch.float32 or do.shape != o.shape:
        raise ValueError(f"flash_attention backward takes an f32 do of shape {tuple(o.shape)}")
    if not _kernel_layout_ok(do):
        do = do.contiguous()
    if segment_ids is not None and (segment_ids.q.data_ptr() % 16 or segment_ids.kv.data_ptr() % 16):
        segment_ids = SegmentIds(segment_ids.q.clone(), segment_ids.kv.clone())
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    di = torch.sum(o * do, dim=-1).contiguous()
    dq = _empty_heads(b, h, tq, dk, q.device)
    dk_, dv = (_empty_heads(b, h, tk, dk, q.device) for _ in range(2))
    strides = (ctypes.c_longlong * 21)(*(s for x in (q, k, v, do, dq, dk_, dv) for s in x.stride()[:3]))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
           di.data_ptr(), *_seg_ptrs(segment_ids))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        rc = lib.flash_attention_bwd_dkv(*ins, dk_.data_ptr(), dv.data_ptr(), b, h, tq, tk, dk, strides,
                                         float(sm_scale), MASK_VALUE, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention dkv launch failed: CUDA error {rc}")
        _count("dkv", tq, tk, segment_ids)
        rc = lib.flash_attention_bwd_dq(*ins, dq.data_ptr(), b, h, tq, tk, dk, strides,
                                        float(sm_scale), MASK_VALUE, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention dq launch failed: CUDA error {rc}")
        _count("dq", tq, tk, segment_ids)
    return dq, dk_, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with residuals, and the dkv and dq kernels as its
    backward. CUDA tensors only; segment ids are passed as two tensors (or
    two Nones) and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale: float):
        seg = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        o, m, l = _forward_kernel(q, k, v, seg, sm_scale, residuals=True)
        ctx.save_for_backward(q, k, v, o, m, l, seg_q, seg_kv)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, seg_q, seg_kv = ctx.saved_tensors
        seg = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        dq, dk, dv = _backward_kernels(q, k, v, o, m, l, do, seg, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, segment_ids: SegmentIds | None = None, sm_scale: float = 1.0):
    """q [B, H, Tq, dk], k/v [B, H, Tk, dk] -> o [B, H, Tq, dk]. A CPU tensor
    goes through `flash_attention_reference` (autograd differentiates it); a
    CUDA tensor through the Hopper kernels, or it raises: the forward kernel
    alone when no gradient is needed, else `FlashAttention`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, segment_ids, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        _check(q, k, v, segment_ids)
        seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
        return FlashAttention.apply(q, k, v, seg_q, seg_kv, float(sm_scale))
    return _forward_kernel(q, k, v, segment_ids, sm_scale, residuals=False)
