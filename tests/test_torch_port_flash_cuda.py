"""The Hopper flash attention forward kernel against its plain version, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests hold
the plain version against the library's reference). On the card it builds
`csrc/flash_attention.cu` and runs it over head widths, lengths, ragged
segment ids (one row all valid) and both input layouts, each against
`flash_attention_reference` on the same f32 inputs, and checks that the
wrapper rejects what the kernel does not take. The kernel runs blocks of
one or two 64-row consumer warpgroups (two when the grid of 128-row blocks
fills the card): one tile (T = 64), a length that leaves a block's second
warpgroup without rows (T = 192), B*H = 1 and a grid large enough for two
warpgroups are covered, and a query whose segment has no key.

Tolerance: the kernel rounds q, k, v and the softmax weights to TF32
(2^-11 relative); the plain version is f32. On N(0, 1) inputs the output
has a range of about 0.5-1 and the error stays near 1e-3 of it: the bound
is max error <= 1e-2 of the output range and relative RMS <= 2e-3.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(b, h, t, dk, seed, device, layout="bhtd"):
    g = torch.Generator().manual_seed(seed)
    shape = (b, h, t, dk) if layout == "bhtd" else (b, t, h, dk)
    q, k, v = (torch.randn(shape, generator=g).to(device) for _ in range(3))
    if layout != "bhtd":  # the [B, T, H, dk] views that come out of the q/k/v linears
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    return q, k, v


def _segments(b, t, device):
    lengths = torch.tensor([t, t - 17, t // 3, 1] * b)[:b]
    ids = (torch.arange(t)[None, :] < lengths[:, None]).to(torch.int32).to(device)
    from efficient_tts_tpu_torch.ops.flash_attention import SegmentIds

    return SegmentIds(ids, ids)


def _check(out, ref):
    err = (out - ref).abs()
    assert float(err.max()) <= 1e-2 * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= 2e-3


@pytest.mark.parametrize("dk", [32, 64, 96, 128])
@pytest.mark.parametrize("t", [128, 256, 512])
@pytest.mark.parametrize("segmented", [False, True])
def test_kernel_matches_plain_version(device, dk, t, segmented):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(3, 2, t, dk, seed=dk + t, device=device)
    seg = _segments(3, t, device) if segmented else None
    scale = 1.0 / dk**0.5
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, seg, scale)
    torch.cuda.synchronize()
    assert fa.launches == {("fwd", t, t, segmented): 1} and out.shape == q.shape
    _check(out, fa.flash_attention_reference(q, k, v, seg, scale))


@pytest.mark.parametrize("dk", [8, 40, 72])
def test_kernel_takes_linear_views_and_odd_head_widths(device, dk):
    """[B, T, H, dk] views (no copy) and dk that the kernel pads to 32/64/96."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(2, 4, 192, dk, seed=dk, device=device, layout="bthd")
    seg = _segments(2, 192, device)
    out = fa.flash_attention(q, k, v, seg, 0.3)
    torch.cuda.synchronize()
    _check(out, fa.flash_attention_reference(q, k, v, seg, 0.3))
    # o is a view of a contiguous [B, T, H, dk] buffer
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("b,h", [(1, 1), (3, 2), (64, 4)])
@pytest.mark.parametrize("t", [64, 192])
@pytest.mark.parametrize("segmented", [False, True])
def test_kernel_at_one_tile_odd_tiles_and_both_block_sizes(device, b, h, t, segmented):
    """T = 64 (one K/V tile) and 192 (not a multiple of 128 rows); B*H = 1,
    6 (one-warpgroup blocks) and 256 (two-warpgroup blocks, where T = 64
    leaves the second warpgroup idle and T = 192 the last block's)."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(b, h, t, 96, seed=b + t, device=device, layout="bthd")
    seg = _segments(b, t, device) if segmented else None
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, seg, 96**-0.5)
    torch.cuda.synchronize()
    assert fa.launches == {("fwd", t, t, segmented): 1}
    _check(out, fa.flash_attention_reference(q, k, v, seg, 96**-0.5))


@pytest.mark.parametrize("dk", [40, 96])
def test_query_whose_segment_has_no_key(device, dk):
    """Such a row's scores are all the finite mask value: its p is uniform
    over the keys and its o the mean of v, not NaN."""
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(2, 2, 128, dk, seed=dk, device=device)
    seg = _segments(2, 128, device)
    ids_q = seg.q.clone()
    ids_q[1, 40] = 2
    seg = fa.SegmentIds(ids_q, seg.kv)
    out = fa.flash_attention(q, k, v, seg, dk**-0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _check(out, fa.flash_attention_reference(q, k, v, seg, dk**-0.5))
    torch.testing.assert_close(out[1, :, 40], v[1].mean(dim=1), rtol=1e-2, atol=1e-2)


def test_kernel_rejects_what_it_does_not_take(device):
    from efficient_tts_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(1, 2, 128, 32, seed=0, device=device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # T not a multiple of 64
        fa.flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])
    with pytest.raises(ValueError):  # dk not a multiple of 8
        fa.flash_attention(q[..., :20], k[..., :20], v[..., :20])
    with pytest.raises(ValueError):  # dk above 128
        big = torch.zeros((1, 1, 64, 136), device=device)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError):  # last stride not 1
        qt = torch.zeros((1, 2, 128, 128), device=device).transpose(2, 3)
        fa.flash_attention(qt, qt, qt)
    with pytest.raises(ValueError):  # segment ids of the wrong type
        ids = torch.ones((1, 128), device=device)
        fa.flash_attention(q, k, v, fa.SegmentIds(ids, ids))
