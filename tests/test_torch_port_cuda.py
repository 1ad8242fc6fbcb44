"""The Hopper MRF kernels against their plain version, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests hold
the plain version against the JAX package). On the card it builds
`csrc/mrf_stage.cu` and runs ragged lengths, every supported channel
width and a one-branch stage, each against `mrf_stage_reference` on the
same inputs, bf16 and f32, and a batch of three utterances whose length is
not a multiple of the kernels' 128-position tile. Generator stages whose
width is not a multiple of 32 (C = 8, 16, 48) run through `MRFStage` on the
kernel at the next multiple of 32, and a stage wider than 256 on the plain
version, each against the stage's plain path.
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


def _stage(c, ks, dils, seed, device, dtype=torch.bfloat16):
    from efficient_tts_tpu_torch.ops.mrf import conv_order

    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn((k, c, c), generator=g) / np.sqrt(k * c)).to(device, dtype)
          for k, _ in conv_order(ks, dils)]
    bs = (0.1 * torch.randn((len(ws), c), generator=g)).to(device)
    return ws, bs


@pytest.mark.parametrize("c,t", [(32, 1000), (64, 333), (128, 64), (256, 71), (96, 130), (160, 200)])
@pytest.mark.parametrize("ks,dils", [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 2),))])
def test_kernel_matches_plain_version(device, c, t, ks, dils):
    """Same rounding points, f32 sums in another order; the bf16 rounding
    flips that follow compound along the 6-conv chain, more at wide C (the
    bound of `chip_smoke.py`): max error <= 2^-5 of the output range,
    relative RMS <= 1e-2."""
    from efficient_tts_tpu_torch.ops import mrf

    ws, bs = _stage(c, ks, dils, seed=c + t, device=device)
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, c), generator=g).to(device, torch.bfloat16)
    mrf.reset_launches()
    out = mrf.mrf_stage(x, mrf.kernel_weights(ws), bs, ks, dils)
    torch.cuda.synchronize()
    assert mrf.launches == {("bf16", c): len(ws)}
    ref = mrf.mrf_stage_reference(x, ws, bs, ks, dils).float()
    err = (out.float() - ref).abs()
    assert float(err.max()) <= 2**-5 * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= 1e-2


@pytest.mark.parametrize("c,t", [(32, 1000), (64, 333), (128, 64), (256, 71), (96, 130), (160, 200)])
@pytest.mark.parametrize("ks,dils", [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 2),))])
def test_f32_kernel_matches_plain_version(device, c, t, ks, dils):
    """The f32 kernel (3xTF32 products) against the plain version with cuDNN
    off TF32: the dropped lo*lo term (below 2^-22 of a product) and the sums'
    order, so relative RMS <= 5e-5 and max error <= 5e-4 of the output range
    (the bound of `chip_smoke.py`)."""
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.utils.precision import full_f32

    ws, bs = _stage(c, ks, dils, seed=c + t, device=device, dtype=torch.float32)
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, c), generator=g).to(device)
    mrf.reset_launches()
    out = mrf.mrf_stage(x, mrf.kernel_weights(ws), bs, ks, dils)
    torch.cuda.synchronize()
    assert mrf.launches == {("f32", c): len(ws)}
    with full_f32():
        ref = mrf.mrf_stage_reference(x, ws, bs, ks, dils)
    err = (out - ref).abs()
    assert float(err.max()) <= 5e-4 * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= 5e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 256])
def test_batch_rows_do_not_bleed_across_utterances(device, dtype, c):
    """B=3 at T=300 (2.3 tiles of 128 positions), each utterance at its own
    scale (1, 100, 0.01): a halo row read from a neighbouring utterance, or a
    pad row not zeroed, moves the small utterance far outside the bound."""
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.utils.precision import full_f32

    ws, bs = _stage(c, (3, 7, 11), ((1, 3, 5),) * 3, seed=c, device=device, dtype=dtype)
    g = torch.Generator().manual_seed(c)
    scale = torch.tensor([1.0, 100.0, 0.01])[:, None, None]
    x = (torch.randn((3, 300, c), generator=g) * scale).to(device, dtype)
    out = mrf.mrf_stage(x, mrf.kernel_weights(ws), bs, (3, 7, 11), ((1, 3, 5),) * 3)
    torch.cuda.synchronize()
    with full_f32():
        ref = mrf.mrf_stage_reference(x, ws, bs, (3, 7, 11), ((1, 3, 5),) * 3)
    tol = (2**-5, 1e-2) if dtype == torch.bfloat16 else (5e-4, 5e-5)
    for i in range(3):
        err = (out[i].float() - ref[i].float()).abs()
        r = ref[i].float()
        assert float(err.max()) <= tol[0] * float(r.abs().max()), i
        assert float((err.square().mean() / r.square().mean()).sqrt()) <= tol[1], i


def test_kernel_rejects_what_it_does_not_take(device):
    from efficient_tts_tpu_torch.ops import mrf

    ks, dils = (3,), ((1,),)
    ws, bs = _stage(32, ks, dils, seed=0, device=device)
    kw = mrf.kernel_weights(ws)
    with pytest.raises(TypeError):  # on the card only the prepared weights
        mrf.mrf_stage(torch.zeros((1, 64, 32), device=device, dtype=torch.bfloat16), ws, bs, ks, dils)
    with pytest.raises(TypeError):
        mrf.mrf_stage(torch.zeros((1, 64, 32), device=device), kw, bs, ks, dils)  # f32 with bf16 weights
    with pytest.raises(TypeError):
        mrf.mrf_stage(torch.zeros((1, 64, 32), device=device, dtype=torch.float16), kw, bs, ks, dils)
    with pytest.raises(ValueError):
        mrf.mrf_stage(torch.zeros((1, 64, 48), device=device, dtype=torch.bfloat16), kw, bs, ks, dils)
    with pytest.raises(ValueError):
        x = torch.zeros((1, 32, 64), device=device, dtype=torch.bfloat16).transpose(1, 2)
        mrf.mrf_stage(x, kw, bs, ks, dils)


def _module_stage(c, ks, dils, seed, device):
    from efficient_tts_tpu_torch.models.hifigan import MRFStage

    rng = np.random.default_rng(seed)
    stage = MRFStage(c, ks, dils)
    stage.load([(rng.standard_normal(s) / np.sqrt(s[0] * c)).astype(np.float32) for s in stage.shapes],
               (0.1 * rng.standard_normal((len(stage.shapes), c))).astype(np.float32))
    return stage.to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [8, 16, 48])
@pytest.mark.parametrize("ks,dils", [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 2),))])
def test_padded_widths_run_the_kernel_through_the_stage(device, dtype, c, ks, dils):
    """A stage of C channels, C not a multiple of 32, runs the kernel at the
    next multiple of 32 (weights and biases zero-padded once, x per call),
    and matches its plain path within the kernel's bounds above."""
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.utils.precision import full_f32

    stage = _module_stage(c, ks, dils, seed=c, device=device)
    g = torch.Generator().manual_seed(c + len(ks))
    x = torch.randn((2, 300, c), generator=g).to(device, dtype)
    mrf.reset_launches()
    out = stage(x)
    torch.cuda.synchronize()
    cp = -(-c // 32) * 32
    assert mrf.launches == {("f32" if dtype == torch.float32 else "bf16", cp): len(stage.shapes)}
    assert out.shape == x.shape and out.dtype == dtype
    with full_f32():
        ref = stage(x, "plain")
    tol = (2**-5, 1e-2) if dtype == torch.bfloat16 else (5e-4, 5e-5)
    err = (out.float() - ref.float()).abs()
    assert float(err.max()) <= tol[0] * float(ref.float().abs().max())
    assert float((err.square().mean() / ref.float().square().mean()).sqrt()) <= tol[1]


def test_stage_wider_than_the_kernel_takes_the_plain_version(device):
    from efficient_tts_tpu_torch.ops import mrf

    stage = _module_stage(288, (3,), ((1,),), seed=0, device=device)
    x = torch.randn((1, 64, 288), generator=torch.Generator().manual_seed(0)).to(device, torch.bfloat16)
    mrf.reset_launches()
    out = stage(x)
    assert mrf.launches == {("plain", 288): 1}
    assert torch.equal(out, stage(x, "plain"))
