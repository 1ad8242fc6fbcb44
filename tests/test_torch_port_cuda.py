"""The Hopper MRF kernels against their plain version, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests hold
the plain version against the JAX package). On the card it builds
`csrc/mrf_stage.cu` and runs ragged lengths, every supported channel
width and a one-branch stage, each against `mrf_stage_reference` on the
same inputs, bf16 and f32.
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


@pytest.mark.parametrize("c,t", [(32, 1000), (64, 333), (128, 64), (256, 71), (96, 130)])
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
    out = mrf.mrf_stage(x, ws, bs, ks, dils)
    torch.cuda.synchronize()
    assert mrf.launches == {("bf16", c): len(ws)}
    ref = mrf.mrf_stage_reference(x, ws, bs, ks, dils).float()
    err = (out.float() - ref).abs()
    assert float(err.max()) <= 2**-5 * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= 1e-2


@pytest.mark.parametrize("c,t", [(32, 1000), (64, 333), (128, 64), (256, 71), (96, 130), (160, 200)])
@pytest.mark.parametrize("ks,dils", [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 2),))])
def test_f32_kernel_matches_plain_version(device, c, t, ks, dils):
    """The f32 kernel (f32 FMAs) against the plain version with cuDNN off
    TF32: no rounding but the sums' order, so relative RMS <= 5e-5 and max
    error <= 5e-4 of the output range (the bound of `chip_smoke.py`)."""
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.utils.precision import full_f32

    ws, bs = _stage(c, ks, dils, seed=c + t, device=device, dtype=torch.float32)
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, c), generator=g).to(device)
    mrf.reset_launches()
    out = mrf.mrf_stage(x, ws, bs, ks, dils)
    torch.cuda.synchronize()
    assert mrf.launches == {("f32", c): len(ws)}
    with full_f32():
        ref = mrf.mrf_stage_reference(x, ws, bs, ks, dils)
    err = (out - ref).abs()
    assert float(err.max()) <= 5e-4 * float(ref.abs().max())
    assert float((err.square().mean() / ref.square().mean()).sqrt()) <= 5e-5


def test_kernel_rejects_what_it_does_not_take(device):
    from efficient_tts_tpu_torch.ops import mrf

    ks, dils = (3,), ((1,),)
    ws, bs = _stage(32, ks, dils, seed=0, device=device)
    with pytest.raises(TypeError):
        mrf.mrf_stage(torch.zeros((1, 64, 32), device=device), ws, bs, ks, dils)  # f32 with bf16 weights
    with pytest.raises(TypeError):
        mrf.mrf_stage(torch.zeros((1, 64, 32), device=device, dtype=torch.float16), ws, bs, ks, dils)
    with pytest.raises(ValueError):
        mrf.mrf_stage(torch.zeros((1, 64, 48), device=device, dtype=torch.bfloat16), ws, bs, ks, dils)
    with pytest.raises(ValueError):
        x = torch.zeros((1, 32, 64), device=device, dtype=torch.bfloat16).transpose(1, 2)
        mrf.mrf_stage(x, ws, bs, ks, dils)
