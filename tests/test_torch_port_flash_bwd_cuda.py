"""The Hopper flash attention backward kernels (dkv, dq) against their plain versions, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests hold
the plain backward against the library's reference). On the card it builds
`csrc/flash_attention.cu` and checks:
  * the forward kernel's residuals m and l against the plain ones;
  * dq, dk and dv through `FlashAttention` (one forward, one dkv and one dq
    launch) against `torch.autograd.grad` through `flash_attention_reference`,
    at the training path's shapes ([64, 4, 512, 96] without segment ids,
    [64, 4, 128, 96] with ragged ones) and over head widths, lengths and
    both input layouts;
  * the dkv and dq kernels against `flash_attention_bwd_reference` fed the
    kernel's own residuals;
  * that the backward's gradients are bitwise the same from run to run (no
    atomics);
  * lengths that are not a multiple of the kernels' 128-row tiles or cover
    one tile only (T = 64, 192) and a long one (T = 1024), narrow heads (dk
    = 8, 40), a query row whose segment matches no key (its p is uniform,
    not NaN), and Tq != Tk, also as a sequence-parallel rank calls them
    (`nn/attention.py:attend`: the rank's rows of a key-padded sequence
    against all its keys, 160 rows padded to 192 with an id no key has).

Tolerance: the kernels round q, k, v, do, p and ds to TF32 (2^-11
relative); the plain versions are f32. On N(0, 1) inputs the gradients'
errors are near 1e-3 of their RMS: the bound is relative RMS <= 5e-3 and
max error <= 2e-2 of the gradient's range. m and l: an error d in a score
moves m by up to d and l by a factor up to exp(d); TF32 operands give d up
to 2^-10 sm_scale sum_i |q_i k_i|, a few 1e-3 on these inputs, so rtol and
atol are 5e-3 (measured on an H100: 1.5e-3 relative at dk = 8).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

GRAD_TOL = {"max_abs_over_range": 2e-2, "rel_rms": 5e-3}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(b, h, t, dk, seed, device, layout="bthd", tk=None):
    """N(0, 1) q, k, v and do; "bthd" gives the [B, H, T, dk] views of [B, T,
    H, dk] tensors that the q/k/v linears give. k and v have tk rows."""
    g = torch.Generator().manual_seed(seed)
    xs = []
    for n in (t, tk or t, tk or t, t):
        shape = (b, h, n, dk) if layout == "bhtd" else (b, n, h, dk)
        x = torch.randn(shape, generator=g).to(device)
        xs.append(x if layout == "bhtd" else x.transpose(1, 2))
    return xs


def _segments(b, t, device, seed=0, tk=None, masked_row=False):
    """Ragged ids (valid 1, pad 0) with one row all valid; for tk, kv ids
    of that length cut at the same fraction. `masked_row` gives one query of
    the last row id 2, which no key has."""
    from efficient_tts_tpu_torch.ops.flash_attention import SegmentIds

    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    ids = (torch.arange(t)[None, :] < lengths[:, None]).to(torch.int32)
    ids_kv = ids if tk is None else (torch.arange(tk)[None, :] * t < lengths[:, None] * tk).to(torch.int32)
    if masked_row:
        ids = ids.clone()
        ids[-1, t // 3] = 2
    return SegmentIds(ids.to(device), ids_kv.to(device))


def _check(out, ref, tol=GRAD_TOL):
    err = (out - ref).abs()
    assert float(err.max()) <= tol["max_abs_over_range"] * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= tol["rel_rms"]


def _grads(fn, q, k, v, do, seg, scale):
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(qs, ks, vs, seg, scale)
    return torch.autograd.grad(out, (qs, ks, vs), do)


@pytest.mark.parametrize("shape,segmented", [((64, 4, 512, 96), False), ((64, 4, 128, 96), True)])
def test_backward_matches_plain_gradients_at_training_shapes(device, shape, segmented):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    b, h, t, dk = shape
    q, k, v, do = _inputs(b, h, t, dk, seed=t, device=device)
    seg = _segments(b, t, device) if segmented else None
    scale = dk**-0.5
    fa.reset_launches()
    got = _grads(fa.flash_attention, q, k, v, do, seg, scale)
    torch.cuda.synchronize()
    assert fa.launches == {(kernel, t, t, segmented): 1 for kernel in ("fwd", "dkv", "dq")}
    ref = _grads(fa.flash_attention_reference, q, k, v, do, seg, scale)
    for out, r in zip(got, ref):
        assert out.shape == r.shape and out.transpose(1, 2).is_contiguous()
        _check(out, r)


@pytest.mark.parametrize("shape", [(64, 4, 512, 96), (64, 4, 128, 96)])
def test_forward_residuals_at_training_shapes(device, shape):
    """The training path's residuals come from the forward kernel: m and l
    at the training shapes (every call masked) against the plain ones, and
    the dkv and dq kernels fed them against the plain backward fed the same."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    b, h, t, dk = shape
    q, k, v, do = _inputs(b, h, t, dk, seed=t + 7, device=device)
    seg = _segments(b, t, device, seed=t)
    scale = dk**-0.5
    o, m, l = fa._forward_kernel(q, k, v, seg, scale, residuals=True)
    o_ref, m_ref, l_ref = fa.flash_attention_reference(q, k, v, seg, scale, return_residuals=True)
    assert m.shape == l.shape == (b, h, t) and m.is_contiguous() and l.is_contiguous()
    torch.testing.assert_close(m, m_ref, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(l, l_ref, rtol=5e-3, atol=5e-3)
    _check(o, o_ref, {"max_abs_over_range": 1e-2, "rel_rms": 2e-3})
    got = fa._backward_kernels(q, k, v, o, m, l, do, seg, scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, m, l, do, seg, scale)
    for out, r in zip(got, ref):
        _check(out, r)


@pytest.mark.parametrize("dk", [32, 64, 96, 128])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_backward_matches_plain_gradients(device, dk, t, segmented, layout):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(3, 2, t, dk, seed=dk + t, device=device, layout=layout)
    seg = _segments(3, t, device, seed=dk) if segmented else None
    scale = 1.0 / dk**0.5
    got = _grads(fa.flash_attention, q, k, v, do, seg, scale)
    ref = _grads(fa.flash_attention_reference, q, k, v, do, seg, scale)
    for out, r in zip(got, ref):
        _check(out, r)


@pytest.mark.parametrize("dk", [8, 40, 96])
def test_forward_residuals_and_kernels_against_the_plain_backward(device, dk):
    """m and l from the forward kernel against the plain ones; the dkv and
    dq kernels against `flash_attention_bwd_reference` on the same residuals."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(2, 4, 192, dk, seed=dk, device=device)
    seg = _segments(2, 192, device, seed=1)
    o, m, l = fa._forward_kernel(q, k, v, seg, 0.3, residuals=True)
    o_ref, m_ref, l_ref = fa.flash_attention_reference(q, k, v, seg, 0.3, return_residuals=True)
    torch.testing.assert_close(m, m_ref, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(l, l_ref, rtol=5e-3, atol=5e-3)
    _check(o, o_ref, {"max_abs_over_range": 1e-2, "rel_rms": 2e-3})
    got = fa._backward_kernels(q, k, v, o, m, l, do, seg, 0.3)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, m, l, do, seg, 0.3)
    for out, r in zip(got, ref):
        _check(out, r)


@pytest.mark.parametrize("t", [64, 192, 1024])
@pytest.mark.parametrize("dk", [8, 40])
@pytest.mark.parametrize("segmented", [False, True])
def test_backward_at_one_tile_odd_tiles_and_long_rows(device, t, dk, segmented):
    """T = 64 (one key block), 192 (three), 1024 (16 blocks of 64 keys, 32
    query tiles); segmented runs hold a query whose segment has no key."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(2, 2, t, dk, seed=t + dk, device=device)
    seg = _segments(2, t, device, seed=dk, masked_row=True) if segmented else None
    scale = dk**-0.5
    got = _grads(fa.flash_attention, q, k, v, do, seg, scale)
    ref = _grads(fa.flash_attention_reference, q, k, v, do, seg, scale)
    for out, r in zip(got, ref):
        assert bool(torch.isfinite(out).all())
        _check(out, r)


@pytest.mark.parametrize("tq,tk", [(64, 192), (1024, 128), (192, 64)])
@pytest.mark.parametrize("segmented", [False, True])
def test_backward_with_more_or_fewer_keys_than_queries(device, tq, tk, segmented):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(2, 3, tq, 40, seed=tq + tk, device=device, tk=tk)
    seg = _segments(2, tq, device, seed=tk, tk=tk, masked_row=True) if segmented else None
    got = _grads(fa.flash_attention, q, k, v, do, seg, 0.2)
    ref = _grads(fa.flash_attention_reference, q, k, v, do, seg, 0.2)
    for out, r in zip(got, ref):
        assert bool(torch.isfinite(out).all())
        _check(out, r)


def test_backward_takes_segment_ids_that_are_not_16_byte_aligned(device):
    """Contiguous int32 ids starting 4 bytes into their storage: the kernels
    read ids 16 bytes at a time, so the backward copies them first."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(2, 2, 128, 32, seed=5, device=device)
    seg = _segments(2, 128, device, seed=5)
    ids = torch.empty(2 * 128 + 1, dtype=torch.int32, device=device)
    ids[1:] = seg.q.reshape(-1)
    unaligned = fa.SegmentIds(ids[1:].view(2, 128), ids[1:].view(2, 128))
    assert unaligned.q.data_ptr() % 16 != 0 and unaligned.q.is_contiguous()
    got = _grads(fa.flash_attention, q, k, v, do, unaligned, 0.3)
    ref = _grads(fa.flash_attention_reference, q, k, v, do, seg, 0.3)
    for out, r in zip(got, ref):
        _check(out, r)


def test_backward_is_deterministic(device):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(4, 4, 256, 96, seed=3, device=device)
    seg = _segments(4, 256, device)
    first = _grads(fa.flash_attention, q, k, v, do, seg, 0.1)
    second = _grads(fa.flash_attention, q, k, v, do, seg, 0.1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_no_gradient_needed_launches_the_forward_alone(device):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _inputs(2, 2, 128, 32, seed=0, device=device)
    fa.reset_launches()
    with torch.no_grad():
        fa.flash_attention(q.detach().requires_grad_(True), k, v)
    assert fa.launches == {("fwd", 128, 128, False): 1}


def test_backward_rejects_what_it_does_not_take(device):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(1, 2, 128, 32, seed=0, device=device)
    o, m, l = fa._forward_kernel(q, k, v, None, 1.0, residuals=True)
    with pytest.raises(ValueError):
        fa._backward_kernels(q, k, v, o, m, l, do[:, :, :64], None, 1.0)
    with pytest.raises(ValueError):
        fa._backward_kernels(q, k, v, o, m, l, do.double(), None, 1.0)


@pytest.mark.parametrize("t,m", [(512, 2), (512, 4), (640, 4)])
def test_sequence_parallel_rows_through_attend(device, t, m):
    """Every rank's rows: the output and dq of its rows, and dk and dv (the
    rank's part of them) of the kernels against the plain path's, one
    launch of each kernel at (the rows padded to 64, T)."""
    from efficient_tts_tpu_torch.nn.attention import attend
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    b, tq = 8, t // m
    q, k, v, _ = _inputs(b, 4, t, 96, seed=t + m, device=device)
    lengths = torch.tensor([t, t // 2, t // 3, 5, t, t - 1, t // 4, 64])
    mask = (torch.arange(t)[None, :] < lengths[:, None])[:, None, :].to(device)
    for i in range(m):
        rows = slice(i * tq, (i + 1) * tq)
        do = torch.randn((b, 4, tq, 96), generator=torch.Generator().manual_seed(i)).to(device)
        fa.reset_launches()
        got = _grads(lambda *x, **_: attend(*x[:3], mask, "flash", start=i * tq), q[:, :, rows], k, v, do, None, 0)
        torch.cuda.synchronize()
        assert fa.launches == {(kernel, tq + -tq % 64, t, True): 1 for kernel in ("fwd", "dkv", "dq")}
        ref = _grads(lambda *x, **_: attend(*x[:3], mask, "flash_plain", start=i * tq), q[:, :, rows], k, v, do,
                     None, 0)
        for out, r in zip(got, ref):
            _check(out, r)
