"""MRF stages at widths the kernels do not take as they are (`ops/mrf.py`).

The MRF kernels take C a multiple of 32 up to 256. A generator stage of
another width up to 256 runs them at the next multiple of 32, its weights
and biases zero-padded once and its activations per call, the result sliced
back (`mrf_stage_any_width`); a wider stage takes the plain version. Here,
on the CPU: the padded plain stage is bit-equal to the unpadded one in f32
and bf16 (the padded channels stay exact zeros), the padded weights that
`MRFStage` caches follow its weights and biases, and the narrow and the
V2-width generators agree with and without the padding.
"""

import numpy as np
import pytest
import torch

from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator, MRFStage
from efficient_tts_tpu_torch.ops import mrf

V1 = ((3, 7, 11), ((1, 3, 5),) * 3)
ONE_BRANCH = ((3,), ((1, 2),))


def _stage_inputs(c, ks, dils, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn((k, c, c), generator=g) / (k * c) ** 0.5).to(dtype) for k, _ in mrf.conv_order(ks, dils)]
    bs = 0.1 * torch.randn((len(ws), c), generator=g)
    x = torch.randn((2, 300, c), generator=g).to(dtype)
    return x, ws, bs


def test_kernel_channels():
    assert [mrf.kernel_channels(c) for c in (2, 8, 16, 32, 33, 48, 64, 250, 256)] == [
        32, 32, 32, 32, 64, 64, 64, 256, 256]
    assert mrf.kernel_channels(257) is None and mrf.kernel_channels(1024) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 8, 16, 48])
@pytest.mark.parametrize("ks,dils", [V1, ONE_BRANCH])
def test_padded_plain_stage_is_bit_equal_to_the_unpadded_one(dtype, c, ks, dils):
    x, ws, bs = _stage_inputs(c, ks, dils, dtype, seed=c)
    cp = mrf.kernel_channels(c)
    wp, bp = mrf.pad_stage(ws, bs, cp)
    assert all(tuple(w.shape) == (w.shape[0], cp, cp) and w.is_contiguous() for w in wp)
    assert tuple(bp.shape) == (len(ws), cp) and bp.dtype == torch.float32
    out = mrf.mrf_stage_reference(mrf.pad_channels(x, cp), wp, bp, ks, dils)
    assert torch.equal(out[..., :c], mrf.mrf_stage_reference(x, ws, bs, ks, dils))
    assert not torch.any(out[..., c:])  # the padded channels stay exact zeros
    # the same through the generator's entry, with the padded weights prepared once
    kw = mrf.kernel_weights(ws, bs)
    assert kw.channels == c and kw.maps is None and torch.equal(kw.biases, bp)
    got = mrf.mrf_stage_any_width(x, kw, bs, ks, dils)
    assert torch.equal(got, out[..., :c])


def test_padded_weights_need_the_biases_and_wide_stages_have_no_kernel_weights():
    _, ws, _ = _stage_inputs(16, *ONE_BRANCH, torch.float32, seed=0)
    with pytest.raises(ValueError):
        mrf.kernel_weights(ws)
    with pytest.raises(ValueError):
        mrf.kernel_weights([torch.zeros((3, 288, 288))])
    kw = mrf.kernel_weights([torch.zeros((3, 64, 64))])
    assert kw.channels is None and kw.biases is None


def test_stage_padded_kernel_weights_follow_the_stage_weights_and_biases():
    """`MRFStage` caches each dtype's padded `KernelWeights` (in f32 the TF32
    split of the padded weights) with the padded biases; loading other
    weights, by `load` or `load_state_dict`, or other biases makes them again
    from the new values."""
    ks, dils = ONE_BRANCH
    rng = np.random.default_rng(5)
    c, cp = 48, 64
    a, b = MRFStage(c, ks, dils), MRFStage(c, ks, dils)
    for stage in (a, b):
        stage.load([rng.standard_normal(s).astype(np.float32) for s in stage.shapes],
                   rng.standard_normal((len(stage.shapes), c)).astype(np.float32))

    def made_from(kw, stage, dtype):
        want, bias = mrf.pad_stage(stage.conv_weights(dtype), stage.bias, cp)
        if dtype == torch.float32:
            want = [mrf.split_tf32x3(w) for w in want]
        return (kw.channels == c and torch.equal(kw.biases, bias) and len(kw.kernel) == len(want)
                and all(torch.equal(u, v) for u, v in zip(kw.kernel, want)))

    kw = a.kernel_weights(torch.float32)
    assert a.kernel_weights(torch.float32) is kw and made_from(kw, a, torch.float32)
    a.load_state_dict(b.state_dict())
    for dtype in (torch.float32, torch.bfloat16):
        assert made_from(a.kernel_weights(dtype), b, dtype)
    a.load([np.zeros(s, np.float32) for s in a.shapes], np.zeros((len(a.shapes), c), np.float32))
    kw = a.kernel_weights(torch.float32)
    assert all(not torch.any(w) for w in kw.kernel) and not torch.any(kw.biases)
    with torch.no_grad():
        a.bias.fill_(1.0)
    kw = a.kernel_weights(torch.bfloat16)
    assert torch.equal(kw.biases[:, :c], torch.ones(len(a.shapes), c)) and not torch.any(kw.biases[:, c:])


@pytest.mark.parametrize("c0", [32, 128])
def test_generator_stages_through_their_padded_weights_match_their_plain_stages(c0):
    """Every stage of a narrow (32) and a V2-width (128) generator through
    its own cached, padded `KernelWeights` on the CPU, against the stage's
    plain path: bit-equal, f32 and bf16."""
    gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=c0))
    rng = np.random.default_rng(c0)
    for stage in gen.stages:
        c = stage.channels
        stage.load([(rng.standard_normal(s) / np.sqrt(s[0] * c)).astype(np.float32) for s in stage.shapes],
                   (0.1 * rng.standard_normal((len(stage.shapes), c))).astype(np.float32))
    assert [s.channels for s in gen.stages] == [c0 // 2, c0 // 4, c0 // 8, c0 // 16]
    for stage in gen.stages:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((2, 70, stage.channels)).astype(np.float32)).to(dtype)
            kw = stage.kernel_weights(dtype)
            assert (kw.channels is None) == (stage.channels % 32 == 0)
            out = mrf.mrf_stage_any_width(x, kw, stage.bias, stage.kernel_sizes, stage.dilation_sizes)
            assert torch.equal(out, stage(x, "plain"))
