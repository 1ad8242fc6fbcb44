"""The Hopper W8A8 MRF kernel (K2) and the matmul rate probe (K5) against
their plain versions, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests hold
the plain versions against the JAX package). On the card it builds
`csrc/mrf_stage_int8.cu` and `csrc/probe_matmul.cu`. K2 runs each conv as
an s8 wgmma implicit GEMM with 128-row blocks and its weights by TMA: the
cases cover C = 32 (32-byte weight rows), widths that are not a multiple of
64, ragged last blocks and utterances of different scales. Both kernels do the
plain versions' arithmetic exactly: integer sums, and every f32 operation
of K2's epilogue rounded as the plain version rounds it, so the results
must be bit-equal (K5's bf16 mode sums in another order: relative RMS
<= 1e-2). K5 is a wgmma kernel on 64-row tiles landed and stored by TMA:
its cases end in partial tiles.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _stage(c, t, ks, dils, seed, device):
    """bf16 x [2, t, c] and the quantized stage of seeded f32 weights."""
    from efficient_tts_tpu_torch.ops.mrf import conv_order
    from efficient_tts_tpu_torch.ops.mrf_int8 import quantize_weights

    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn((k, c, c), generator=g) / np.sqrt(k * c)) for k, _ in conv_order(ks, dils)]
    bs = (0.1 * torch.randn((len(ws), c), generator=g)).to(device)
    x = torch.randn((2, t, c), generator=g).to(device, torch.bfloat16)
    wq, scales = quantize_weights(ws)
    return x, [w.to(device) for w in wq], scales.to(device), bs, ws


@pytest.mark.parametrize("c,t", [(32, 1000), (64, 333), (128, 64), (256, 71), (96, 130)])
@pytest.mark.parametrize("ks,dils", [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 2),))])
@pytest.mark.parametrize("static", [False, True])
def test_int8_kernel_is_bit_equal_to_plain_version(device, c, t, ks, dils, static):
    from efficient_tts_tpu_torch.ops import mrf_int8

    x, wq, scales, bs, ws = _stage(c, t, ks, dils, seed=c + t, device=device)
    act = None
    if static:
        act = mrf_int8.calibrate_act_scales(x, [w.to(device) for w in ws], bs, ks, dils)
    mrf_int8.reset_launches()
    out = mrf_int8.mrf_stage_int8(x, wq, scales, bs, ks, dils, act)
    torch.cuda.synchronize()
    expected = {("static" if static else "dynamic", c): len(wq)}
    if not static:
        expected["absmax", c] = 1
    assert mrf_int8.launches == expected
    ref = mrf_int8.mrf_stage_int8_reference(x, wq, scales, bs, ks, dils, act)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


@pytest.mark.parametrize("c,t", [(32, 300), (224, 150), (160, 257)])
@pytest.mark.parametrize("static", [False, True])
def test_int8_kernel_new_widths_and_per_utterance_scales(device, c, t, static):
    """C = 32 with a ragged last 128-row block, C = 224 and 160 (widths
    that are not a multiple of 64), a batch whose two utterances have
    absmax scales 8x apart, and weights prepared once (`kernel_weights`)
    for two calls; bit-equal in every case."""
    from efficient_tts_tpu_torch.ops import mrf_int8

    ks, dils = (3, 7, 11), ((1, 3, 5),) * 3
    x, wq, scales, bs, ws = _stage(c, t, ks, dils, seed=c * t, device=device)
    x = x * torch.tensor([1.0, 8.0], device=device, dtype=x.dtype)[:, None, None]
    amax = mrf_int8.dynamic_scale(x)
    assert float(amax[1]) > 4 * float(amax[0])
    act = mrf_int8.calibrate_act_scales(x, [w.to(device) for w in ws], bs, ks, dils) if static else None
    kw = mrf_int8.kernel_weights(wq)
    mrf_int8.reset_launches()
    out = mrf_int8.mrf_stage_int8(x, kw, scales, bs, ks, dils, act)
    again = mrf_int8.mrf_stage_int8(x, kw, scales, bs, ks, dils, act)
    torch.cuda.synchronize()
    assert mrf_int8.launches[("static" if static else "dynamic", c)] == 2 * len(wq)
    ref = mrf_int8.mrf_stage_int8_reference(x, wq, scales, bs, ks, dils, act)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    assert torch.equal(again, out)


def test_int8_kernel_rejects_what_it_does_not_take(device):
    from efficient_tts_tpu_torch.ops import mrf_int8

    ks, dils = (3,), ((1,),)
    x, wq, scales, bs, _ = _stage(32, 64, ks, dils, seed=0, device=device)
    with pytest.raises(TypeError):
        mrf_int8.mrf_stage_int8(x.float(), wq, scales, bs, ks, dils)
    with pytest.raises(TypeError):
        mrf_int8.mrf_stage_int8(x, [w.to(torch.bfloat16) for w in wq], scales, bs, ks, dils)
    with pytest.raises(TypeError):
        mrf_int8.mrf_stage_int8(x, wq, scales, bs, ks, dils, torch.ones(3, device=device))


def _probe_inputs(mode, m, device):
    rng = np.random.default_rng(m)
    if mode == "int8":
        x, w, dt = rng.integers(-3, 3, (m, 128)), rng.integers(-3, 3, (128, 128)), torch.int8
    else:
        x, w, dt = rng.standard_normal((m, 128)), 0.05 * rng.standard_normal((128, 128)), torch.bfloat16
    return [torch.from_numpy(a).to(device).to(dt).contiguous() for a in (x, w)]


def _check_probe(mode, out, ref):
    if mode == "int8":
        assert torch.equal(out, ref)
    else:
        err = (out.float() - ref.float()).square().mean().sqrt()
        assert float(err / ref.float().square().mean().sqrt()) <= 1e-2


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("m", [16, 48, 80, 4096, 3000 * 16, 1 << 20, (1 << 20) + 16])
def test_probe_kernel_matches_plain_version(device, mode, m):
    """K5 lands x in 64-row tiles by TMA, zero-filled past M, and stores by
    TMA, clipped at M: M below one tile (16, 48), a tile and a part (80),
    the bench's 2^20 and 2^20 + 16. Its store into a larger buffer leaves
    the rows past M untouched."""
    import ctypes

    from efficient_tts_tpu_torch.ops import probe_matmul as pm

    x, w = _probe_inputs(mode, m, device)
    pm.reset_launches()
    out = pm.probe_matmul(x, w)
    torch.cuda.synchronize()
    assert pm.launches == {mode: 1}
    _check_probe(mode, out, pm.probe_matmul_reference(x, w))
    big = torch.full((m + 64, 128), 7, dtype=x.dtype, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    assert pm._lib().probe_matmul(x.data_ptr(), w.data_ptr(), big.data_ptr(), m, 8, int(mode == "int8"), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(big[:m], out) and bool((big[m:] == 7).all())


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("repeat", [1, 3])
def test_probe_kernel_other_repeat_counts(device, mode, repeat):
    from efficient_tts_tpu_torch.ops import probe_matmul as pm

    x, w = _probe_inputs(mode, 4096 + 48, device)
    _check_probe(mode, pm.probe_matmul(x, w, repeat), pm.probe_matmul_reference(x, w, repeat))


def test_probe_rejects_a_misaligned_input(device):
    from efficient_tts_tpu_torch.ops import probe_matmul as pm

    x, w = _probe_inputs("int8", 64 + 16, device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pm.probe_matmul(x.view(-1)[8:8 + 64 * 128].view(64, 128), w)
