"""Port MRF stage (`efficient_tts_tpu_torch/ops/mrf.py`) against the JAX package.

The plain version `mrf_stage_reference` is the CPU twin of the Hopper kernel
`csrc/mrf_stage.cu`; here it is held against the TPU kernels it replaces
(run in Pallas interpret mode) and against the XLA ResBlock1 path. Inputs and
weights come from a numpy seed; weights have unit gain (std 1/sqrt(k*C)) so
every conv of the chain moves the output.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from efficient_tts_tpu.models import hifigan as hg
from efficient_tts_tpu.ops.pallas.mrf import mrf_stage as pallas_mrf_stage
from efficient_tts_tpu.ops.pallas.mrf import pack_resblock_weights
from efficient_tts_tpu.ops.pallas.mrf_packed import mrf_stage_packed, pack_stage_weights
from efficient_tts_tpu_torch.ops import mrf

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _blocks(c, seed, ks=KS, dils=DILS):
    rng = np.random.default_rng(seed)
    blocks = []
    for k, ds in zip(ks, dils):
        std = 1.0 / np.sqrt(k * c)
        blocks.append({
            name: [{"w": (std * rng.standard_normal((k, c, c))).astype(np.float32),
                    "b": (0.1 * rng.standard_normal(c)).astype(np.float32)} for _ in ds]
            for name in ("convs1", "convs2")
        })
    return blocks


def _port_weights(blocks, dtype):
    """JAX WIO [k, in, out] -> the kernel layout [k, out, in], conv order."""
    ws, bs = [], []
    for block in blocks:
        for c1, c2 in zip(block["convs1"], block["convs2"]):
            for conv in (c1, c2):
                ws.append(torch.from_numpy(np.ascontiguousarray(np.transpose(conv["w"], (0, 2, 1)))).to(dtype))
                bs.append(conv["b"])
    return ws, torch.from_numpy(np.stack(bs))


def _bf16_input(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


def _xla_stage(blocks, x, ks=KS, dils=DILS):
    acc = None
    for block, k, ds in zip(blocks, ks, dils):
        y = hg._resblock1(block, x, k, ds)
        acc = y if acc is None else acc + y
    return np.asarray((acc / len(ks)).astype(jnp.float32))


def _assert_bf16_close(out, ref, max_frac, rms):
    err = np.abs(out - ref)
    scale = np.abs(ref).max()
    assert err.max() <= max_frac * scale, (err.max(), scale)
    assert np.sqrt(np.mean(err**2) / np.mean(ref**2)) <= rms


@pytest.mark.parametrize("c,t", [(32, 160), (64, 80)])
def test_reference_matches_packed_pallas_kernel(c, t):
    """K1 (`mrf_stage_packed`, bf16 mode) after the contiguous [B, T, C] ->
    [B, T/r, 128] reshape. M = T/r = 40 is not a multiple of t_tile=32, so
    the ragged tail is hit. Same rounding points as the port; the f32 sums
    run in another order, which flips a bf16 rounding now and then and the
    flip carries down the chain: max error <= 2^-6 of the output range
    (measured 2^-8), relative RMS <= 2e-3 (measured 9e-4)."""
    r = 128 // c
    blocks = _blocks(c, seed=c)
    xj, xt = _bf16_input((2, t, c), seed=1)
    wp, biases = pack_stage_weights(blocks, KS, DILS, r, c)
    out = mrf_stage_packed(
        xj.reshape(2, t // r, 128), wp.astype(jnp.bfloat16), jnp.zeros((18, 128), jnp.float32),
        biases, KS, DILS, r, t_tile=32, int8=False, interpret=True,
    )
    out = np.asarray(out.astype(jnp.float32)).reshape(2, t, c)
    ws, bs = _port_weights(blocks, torch.bfloat16)
    ref = mrf.mrf_stage_reference(xt, ws, bs, KS, DILS).float().numpy()
    _assert_bf16_close(ref, out, 2**-6, 2e-3)


def test_reference_matches_im2col_pallas_kernel():
    """K3 (`ops/pallas/mrf.py:mrf_stage`, bf16) at (1, 256, 32), t_tile=128.
    K3 rounds each conv to bf16 before adding a bf16-rounded bias (two
    roundings where the port has one), so the bound is looser: max error
    <= 2^-4 of the range (measured 2^-6.5), relative RMS <= 1e-2 (measured
    4.6e-3)."""
    c = 32
    blocks = _blocks(c, seed=5)
    xj, xt = _bf16_input((1, 256, c), seed=2)
    w3, b3 = zip(*[pack_resblock_weights(blocks[j], KS[j], c) for j in range(3)])
    out = np.asarray(pallas_mrf_stage(xj, w3, b3, KS, DILS, t_tile=128, interpret=True).astype(jnp.float32))
    ws, bs = _port_weights(blocks, torch.bfloat16)
    ref = mrf.mrf_stage_reference(xt, ws, bs, KS, DILS).float().numpy()
    _assert_bf16_close(ref, out, 2**-4, 1e-2)


@pytest.mark.parametrize("b,c,t_tile", [(1, 32, 128), (2, 64, 64)])
def test_f32_reference_matches_im2col_pallas_kernel(b, c, t_tile):
    """K3 (`ops/pallas/mrf.py:mrf_stage`) in f32, the mode the port's f32
    kernel replaces, at T=256 in 2 and 4 tiles: no rounding but the f32
    sums' order (rtol 1e-5)."""
    blocks = _blocks(c, seed=c + 1)
    x = np.random.default_rng(6).standard_normal((b, 256, c)).astype(np.float32)
    w3, b3 = zip(*[pack_resblock_weights(blocks[j], KS[j], c) for j in range(3)])
    out = np.asarray(pallas_mrf_stage(jnp.asarray(x), w3, b3, KS, DILS, t_tile=t_tile, interpret=True))
    ws, bs = _port_weights(blocks, torch.float32)
    ref = mrf.mrf_stage_reference(torch.from_numpy(x), ws, bs, KS, DILS).numpy()
    np.testing.assert_allclose(ref, out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_averaged_resblock1(c, dtype):
    """The XLA path (`_resblock1` x 3, averaged) at short T. f32: the same
    math up to f32 summation order (rtol 1e-5). bf16: XLA rounds the conv
    before a bf16 bias add, as K3 does; same bound as the K3 test."""
    blocks = _blocks(c, seed=c)
    x = np.random.default_rng(3).standard_normal((2, 48, c)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    out = _xla_stage(blocks, xj)
    ws, bs = _port_weights(blocks, getattr(torch, dtype))
    ref = mrf.mrf_stage_reference(xt, ws, bs, KS, DILS).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ref, out, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(ref, out, 2**-4, 1e-2)


def test_single_branch_stage_matches_resblock1():
    """A stage of one branch with two units (the shape of the JAX package's
    small test generators): the average over one branch is the branch."""
    ks, dils = (3,), ((1, 2),)
    blocks = _blocks(32, seed=7, ks=ks, dils=dils)
    x = np.random.default_rng(4).standard_normal((1, 40, 32)).astype(np.float32)
    out = _xla_stage(blocks, jnp.asarray(x), ks, dils)
    ws, bs = _port_weights(blocks, torch.float32)
    ref = mrf.mrf_stage_reference(torch.from_numpy(x), ws, bs, ks, dils).numpy()
    np.testing.assert_allclose(ref, out, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    blocks = _blocks(32, seed=9)
    _, xt = _bf16_input((1, 64, 32), seed=5)
    ws, bs = _port_weights(blocks, torch.bfloat16)
    mrf.reset_launches()
    out = mrf.mrf_stage(xt, ws, bs, KS, DILS)
    torch.testing.assert_close(out, mrf.mrf_stage_reference(xt, ws, bs, KS, DILS), rtol=0, atol=0)
    assert mrf.launches == {}  # the plain version launches nothing
    meta = torch.empty((1, 64, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mrf.mrf_stage(meta, ws, bs, KS, DILS)



def test_check_takes_bf16_or_f32_with_weights_of_the_same_dtype():
    """The card's checks (they run on any device): bf16 and f32 activations
    pass with weights of their dtype; mixed dtypes and other types raise."""
    blocks = _blocks(32, seed=9)
    x = torch.zeros((1, 64, 32))
    for dt in (torch.float32, torch.bfloat16):
        ws, bs = _port_weights(blocks, dt)
        mrf._check(x.to(dt), ws, bs, KS, DILS)
    ws32, bs = _port_weights(blocks, torch.float32)
    ws16, _ = _port_weights(blocks, torch.bfloat16)
    for xx, ws in ((x, ws16), (x.to(torch.bfloat16), ws32), (x.half(), [w.half() for w in ws32])):
        with pytest.raises(TypeError):
            mrf._check(xx, ws, bs, KS, DILS)
    mrf.reset_launches()
    out = mrf.mrf_stage(x + 1, ws32, bs, KS, DILS)
    assert out.dtype == torch.float32 and mrf.launches == {}


@pytest.mark.parametrize("c", [32, 96, 256])
def test_stage_weights_are_aligned_views_in_both_dtypes(c):
    """The kernels take each conv's weight in place: `conv_weights` gives
    16-byte aligned views of the stage's f32 and bf16 buffers."""
    from efficient_tts_tpu_torch.models.hifigan import MRFStage

    stage = MRFStage(c, KS, DILS)
    for dt, buf in ((torch.float32, stage.weight), (torch.bfloat16, stage.weight_bf16)):
        ws = stage.conv_weights(dt)
        assert len(ws) == 18 and all(w.dtype == dt and w.is_contiguous() for w in ws)
        assert all(w.data_ptr() % 16 == 0 and w.untyped_storage().data_ptr() == buf.data_ptr() for w in ws)
