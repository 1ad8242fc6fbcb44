"""The f32 MRF kernel's 3xTF32 products, emulated on the CPU, against the JAX package.

On the card the f32 MRF kernel (`csrc/mrf_stage.cu:mrf_conv_f32`) splits each
operand v into hi = tf32(v) and lo = tf32(v - hi), rounding to nearest with
ties away, and sums lo*hi + hi*lo + hi*hi in f32. Here the same split
(`ops/mrf.py:round_tf32`, `split_tf32x3`) runs in torch: the activations
after leaky, the weights as the kernel's [2, k, C, C] layout holds them, and
each product pass as an f32 conv of TF32 values (their products are exact in
f32). A whole V1 stage through it is held against the TPU kernel it replaces,
`ops/pallas/mrf.py:mrf_stage` in f32 (Pallas interpret mode), within the
card's bound for the f32 kernel (`chip_smoke.py`'s F32_STAGE_TOL). A single
TF32 pass must miss that bound: that is why the kernel takes three.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from efficient_tts_tpu.ops.pallas.mrf import mrf_stage as pallas_mrf_stage
from efficient_tts_tpu.ops.pallas.mrf import pack_resblock_weights
from efficient_tts_tpu_torch.nn.layers import leaky_relu
from efficient_tts_tpu_torch.ops import mrf

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
# chip_smoke.py's F32_STAGE_TOL: max error over the output range, relative RMS
F32_STAGE_TOL = {"max_abs_over_range": 5e-4, "rel_rms": 5e-5}


def _blocks(c, seed):
    rng = np.random.default_rng(seed)
    return [{name: [{"w": (rng.standard_normal((k, c, c)) / np.sqrt(k * c)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(c)).astype(np.float32)} for _ in ds]
             for name in ("convs1", "convs2")} for k, ds in zip(KS, DILS)]


def _port_weights(blocks):
    """JAX WIO [k, in, out] -> [k, out, in] in conv order, and biases."""
    ws, bs = [], []
    for block in blocks:
        for c1, c2 in zip(block["convs1"], block["convs2"]):
            for conv in (c1, c2):
                ws.append(torch.from_numpy(np.ascontiguousarray(np.transpose(conv["w"], (0, 2, 1)))))
                bs.append(conv["b"])
    return ws, torch.from_numpy(np.stack(bs))


def _emulated_stage(x, ws, bs, passes):
    """The stage with each conv's products as the kernel forms them: three
    TF32 passes (lo*hi, hi*lo, hi*hi) or one (hi*hi)."""
    split = [mrf.split_tf32x3(w) for w in ws]

    def conv(a, i, d):
        k = ws[i].shape[0]
        a = leaky_relu(a, mrf.LRELU_SLOPE)
        a_hi = mrf.round_tf32(a)
        a_lo = mrf.round_tf32(a - a_hi)
        w_hi, w_lo = split[i]

        def product(u, w):
            y = F.conv1d(u.transpose(1, 2), w.permute(1, 2, 0), padding=(k - 1) // 2 * d, dilation=d)
            return y.transpose(1, 2)

        y = product(a_hi, w_hi) if passes == 1 else product(a_lo, w_hi) + product(a_hi, w_lo) + product(a_hi, w_hi)
        return y + bs[i]

    return mrf.stage_chain(x, conv, DILS)


def _stats(out, ref):
    err = np.abs(out - ref)
    return {"max_abs_over_range": err.max() / np.abs(ref).max(),
            "rel_rms": np.sqrt(np.mean(err**2) / np.mean(ref**2))}


def test_tf32_rounding_is_nearest_ties_away():
    # 1 + 2^-11 is halfway between two TF32 values: ties go away from zero
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 0.0])
    assert torch.equal(mrf.round_tf32(x), want)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 32, 32)).astype(np.float32))
    s = mrf.split_tf32x3(w)
    assert s.shape == (2, 3, 32, 32) and s.is_contiguous()
    for part in s:
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)  # TF32 values: 13 low bits clear
    assert float((s[0] + s[1] - w).abs().max()) <= 2**-21 * float(w.abs().max())


@pytest.mark.parametrize("c", [32])
def test_tf32x3_stage_matches_jax_f32_kernel_and_one_pass_does_not(c):
    blocks = _blocks(c, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 256, c)).astype(np.float32)
    w3, b3 = zip(*[pack_resblock_weights(blocks[j], KS[j], c) for j in range(3)])
    ref = np.asarray(pallas_mrf_stage(jnp.asarray(x), w3, b3, KS, DILS, t_tile=128, interpret=True))
    ws, bs = _port_weights(blocks)
    xt = torch.from_numpy(x)
    three = _stats(_emulated_stage(xt, ws, bs, passes=3).numpy(), ref)
    one = _stats(_emulated_stage(xt, ws, bs, passes=1).numpy(), ref)
    assert all(three[key] <= F32_STAGE_TOL[key] for key in F32_STAGE_TOL), three
    assert any(one[key] > F32_STAGE_TOL[key] for key in F32_STAGE_TOL), one


def test_stage_kernel_weights_follow_the_stage_weights():
    """`MRFStage` caches each dtype's `KernelWeights` (in f32 the TF32 split
    of its weights); loading other weights, by `load` or `load_state_dict`,
    makes them again from the new weights."""
    from efficient_tts_tpu_torch.models.hifigan import MRFStage

    ks, dils = (3,), ((1, 2),)
    rng = np.random.default_rng(3)
    a, b = MRFStage(32, ks, dils), MRFStage(32, ks, dils)
    for stage in (a, b):
        stage.load([rng.standard_normal(s).astype(np.float32) for s in stage.shapes],
                   rng.standard_normal((len(stage.shapes), 32)).astype(np.float32))

    def made_from(kw, stage, dtype):
        want = stage.conv_weights(dtype)
        if dtype == torch.float32:
            want = [mrf.split_tf32x3(w) for w in want]
        return len(kw.kernel) == len(want) and all(torch.equal(u, v) for u, v in zip(kw.kernel, want))

    kw = a.kernel_weights(torch.float32)
    assert a.kernel_weights(torch.float32) is kw and made_from(kw, a, torch.float32)
    a.load_state_dict(b.state_dict())
    for dtype in (torch.float32, torch.bfloat16):
        assert made_from(a.kernel_weights(dtype), b, dtype)
    a.load([np.zeros(s, np.float32) for s in a.shapes], np.zeros((len(a.shapes), 32), np.float32))
    assert all(not torch.any(w) for w in a.kernel_weights(torch.float32).kernel)
