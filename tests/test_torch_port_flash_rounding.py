"""The flash kernels' operand rounding, emulated on the CPU, against the JAX library.

On the card the forward kernel (`csrc/flash_attention.cu`) rounds q, k and
v to TF32 in shared memory and the softmax weights p to TF32 in registers
(cvt.rna) before the products read them; the scale, mask, online softmax
(per 64-key tile: running max, rescaling of o and l) and every sum are
f32. `emulated_forward` does that arithmetic in torch and is held against
the library's `mha_reference_no_custom_vjp` forward in f32 within the card
bound `FLASH_TOL` (chip_smoke.py), including a query whose segment has no
key; truncated operands land further off.

On the card the dkv and dq kernels (`csrc/flash_attention.cu`) round q, k,
v and do to TF32 (to nearest, ties away: `ops/mrf.py:round_tf32`, as
cvt.rna rounds) before the products read them, form p = exp(x - m) / l and
ds = ((dp - di) p) * scale in f32, and round p and ds to TF32 before the
second products; every sum is f32. A product of two TF32 values is exact
in f32, so torch reproduces that arithmetic here up to the order of the
sums. The emulation is held against the gradients of the TPU kernel's
reference, `mha_reference_no_custom_vjp` in f32 (the library's flash
backward cannot run on a CPU), within the card tests' bound `GRAD_TOL`
(tests/test_torch_port_flash_bwd_cuda.py), including a query whose segment
has no key. Truncating the operands instead of rounding them, which a raw
wgmma on unrounded f32 tiles would do, moves the gradients further from
the reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp
from efficient_tts_tpu_torch.ops import flash_attention as fa
from efficient_tts_tpu_torch.ops.mrf import round_tf32

# the card tests' bound for the backward kernels against plain f32 gradients
GRAD_TOL = {"max_abs_over_range": 2e-2, "rel_rms": 5e-3}
# chip_smoke.py's bound for the forward kernel against the plain f32 forward
FLASH_TOL = {"max_abs_over_range": 1e-2, "rel_rms": 2e-3}
# keys per K/V tile of the forward kernel (head widths up to 96)
FWD_TILE = 64


def truncate_tf32(x):
    """The top 19 bits of each f32: what a TF32 wgmma reads of an unrounded value."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def emulated_backward(q, k, v, o, m, l, do, seg, scale, rnd=round_tf32):
    """dq, dk, dv with the kernels' rounding points: q, k, v, do, p and ds
    through `rnd`, the rest f32."""
    qr, kr, vr, dor = (rnd(x) for x in (q, k, v, do))
    x = torch.einsum("bhqc,bhkc->bhqk", qr, kr) * scale
    if seg is not None:
        same = seg.q[:, None, :, None] == seg.kv[:, None, None, :]
        x = x + torch.where(same, 0.0, fa.MASK_VALUE)
    p = torch.exp(x - m[..., None]) / l[..., None]
    dp = torch.einsum("bhqc,bhkc->bhqk", dor, vr)
    di = torch.sum(o * do, dim=-1)[..., None]
    ds = rnd((dp - di) * p * scale)
    p = rnd(p)
    dv = torch.einsum("bhqk,bhqc->bhkc", p, dor)
    dk = torch.einsum("bhqk,bhqc->bhkc", ds, qr)
    dq = torch.einsum("bhqk,bhkc->bhqc", ds, kr)
    return dq, dk, dv


def emulated_forward(q, k, v, seg, scale, rnd=round_tf32, tile=FWD_TILE):
    """o with the forward kernel's rounding points: q, k, v through `rnd`,
    then per tile of keys the f32 online softmax (running max m, o and l
    rescaled by exp(m_old - m_new)) with p through `rnd` before p v; l sums
    the unrounded p, and o / l keeps the library's l == 0 guard."""
    qr, kr, vr = (rnd(x) for x in (q, k, v))
    x = torch.einsum("bhqc,bhkc->bhqk", qr, kr) * scale
    if seg is not None:
        same = seg.q[:, None, :, None] == seg.kv[:, None, None, :]
        x = x + torch.where(same, 0.0, fa.MASK_VALUE)
    m = torch.full(x.shape[:-1], -float("inf"))
    l = torch.zeros(x.shape[:-1])
    o = torch.zeros(q.shape)
    for j in range(0, x.shape[-1], tile):
        xj = x[..., j:j + tile]
        mn = torch.maximum(m, xj.amax(dim=-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(xj - mn[..., None])
        l = alpha * l + p.sum(dim=-1)
        o = alpha[..., None] * o + torch.einsum("bhqk,bhkc->bhqc", rnd(p), vr[:, :, j:j + tile])
        m = mn
    return o * torch.where(l == 0.0, 1.0, 1.0 / l)[..., None]


def _stats(out, ref):
    err = np.abs(out - ref)
    return {"max_abs_over_range": float(err.max() / np.abs(ref).max()),
            "rel_rms": float(np.sqrt(np.mean(err**2) / np.mean(ref**2)))}


@pytest.mark.parametrize("dk", [40, 96])
@pytest.mark.parametrize("segmented", [False, True])
def test_rounded_backward_matches_the_library_within_the_card_bound(dk, segmented):
    b, h, t = 2, 2, 128
    rng = np.random.default_rng(dk)
    q, k, v, do = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(4))
    scale = dk**-0.5
    seg_t = seg_j = None
    if segmented:
        ids = (np.arange(t)[None, :] < np.array([t, 77])[:, None]).astype(np.int32)
        ids_q = ids.copy()
        ids_q[1, 40] = 2  # a query whose segment has no key
        seg_t = fa.SegmentIds(torch.from_numpy(ids_q), torch.from_numpy(ids))
        seg_j = JSegmentIds(q=jnp.asarray(ids_q), kv=jnp.asarray(ids))
    _, vjp = jax.vjp(lambda a, b_, c: mha_reference_no_custom_vjp(a, b_, c, segment_ids=seg_j, sm_scale=scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, m, l = fa.flash_attention_reference(tq, tk, tv, seg_t, scale, return_residuals=True)
    rounded = [_stats(g.numpy(), r) for g, r in zip(emulated_backward(tq, tk, tv, o, m, l, tdo, seg_t, scale), ref)]
    truncated = [_stats(g.numpy(), r) for g, r in
                 zip(emulated_backward(tq, tk, tv, o, m, l, tdo, seg_t, scale, truncate_tf32), ref)]
    for st in rounded:
        assert all(st[key] <= GRAD_TOL[key] for key in GRAD_TOL), rounded
        assert st["rel_rms"] > 0  # the rounding is there
    assert sum(st["rel_rms"] for st in truncated) > sum(st["rel_rms"] for st in rounded), (rounded, truncated)


@pytest.mark.parametrize("dk", [40, 96])
@pytest.mark.parametrize("segmented", [False, True])
def test_rounded_forward_matches_the_library_within_the_card_bound(dk, segmented):
    b, h, t = 2, 2, 192
    rng = np.random.default_rng(dk + 1)
    q, k, v = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(3))
    scale = dk**-0.5
    seg_t = seg_j = None
    if segmented:
        ids = (np.arange(t)[None, :] < np.array([t, 101])[:, None]).astype(np.int32)
        ids_q = ids.copy()
        ids_q[1, 40] = 2  # a query whose segment has no key
        seg_t = fa.SegmentIds(torch.from_numpy(ids_q), torch.from_numpy(ids))
        seg_j = JSegmentIds(q=jnp.asarray(ids_q), kv=jnp.asarray(ids))
    ref = np.asarray(mha_reference_no_custom_vjp(*(jnp.asarray(a) for a in (q, k, v)), segment_ids=seg_j,
                                                 sm_scale=scale))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    rounded = _stats(emulated_forward(tq, tk, tv, seg_t, scale).numpy(), ref)
    truncated = _stats(emulated_forward(tq, tk, tv, seg_t, scale, truncate_tf32).numpy(), ref)
    assert all(rounded[key] <= FLASH_TOL[key] for key in FLASH_TOL), rounded
    assert rounded["rel_rms"] > 0  # the rounding is there
    assert truncated["rel_rms"] > rounded["rel_rms"], (rounded, truncated)
    # the emulation without rounding is the plain forward, up to the order of f32 sums
    exact = _stats(emulated_forward(tq, tk, tv, seg_t, scale, lambda x: x).numpy(), ref)
    assert exact["rel_rms"] < 1e-5, exact
