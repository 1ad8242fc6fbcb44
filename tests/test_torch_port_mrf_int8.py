"""Port W8A8 MRF stage (`efficient_tts_tpu_torch/ops/mrf_int8.py`) against the
JAX package's `ops/pallas/mrf_packed.py` with int8=True.

The setup is `tests/test_mrf_packed_kernel.py`'s: C=32, r=4, weights
0.15 N(0, 1) from jax.random, x 0.5 N(0, 1) [2, 96, 128] packed, which is
[2, 384, 32] plain. The port quantizes per output channel on the plain
weights; the JAX package per packed output lane on the scattered weights.
The two must agree exactly, and so must the plain stages built on them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.models.hifigan import _pack_plan
from efficient_tts_tpu.ops.pallas import mrf_packed as jmp
from efficient_tts_tpu_torch.ops import mrf, mrf_int8

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
R, C = 4, 32


@pytest.fixture(scope="module")
def setup():
    keys = jax.random.split(jax.random.PRNGKey(0), 19)
    blocks = []
    i = 0
    for k in KS:
        blocks.append({
            "convs1": [{"w": 0.15 * jax.random.normal(keys[i + j], (k, C, C)),
                        "b": 0.1 * jax.random.normal(keys[i + j + 3], (C,))} for j in range(3)],
            "convs2": [{"w": 0.15 * jax.random.normal(keys[i + j + 6], (k, C, C)),
                        "b": 0.1 * jax.random.normal(keys[i + j + 9], (C,))} for j in range(3)],
        })
        i += 2
    wp, biases = jmp.pack_stage_weights(blocks, KS, DILS, R, C)
    plan, _ = jmp.stage_plan(KS, DILS, R)
    wq, scales = jmp.quantize_weights(wp, plan)
    x = jnp.asarray(0.5 * np.random.default_rng(0).standard_normal((2, 96, 128)), jnp.bfloat16)
    # the port's weights: JAX's [k, C_in, C_out] -> [k, C_out, C_in], conv order
    ws, bs = [], []
    for block in blocks:
        for c1, c2 in zip(block["convs1"], block["convs2"]):
            for conv in (c1, c2):
                ws.append(torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(conv["w"]), (0, 2, 1)))))
                bs.append(np.asarray(conv["b"]))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16).reshape(2, 96 * R, C)
    return {"blocks": blocks, "wp": wp, "plan": plan, "wq": wq, "scales": scales, "biases": biases, "x": x,
            "ws": ws, "bs": torch.from_numpy(np.stack(bs)), "xt": xt}


def _port_stage(st, act=None):
    wq, scales = mrf_int8.quantize_weights(st["ws"])
    out = mrf_int8.mrf_stage_int8_reference(st["xt"], wq, scales, st["bs"], KS, DILS, act)
    return np.asarray(out.float().numpy()).reshape(2, 96, 128)


def test_quantize_weights_match_jax(setup):
    """Per-output-channel scales equal JAX's per-lane scales on every lane
    group; the int8 weights scattered by the packing plan equal JAX's packed
    int8 weights everywhere (zeros included)."""
    wq, scales = mrf_int8.quantize_weights(setup["ws"])
    jscales = np.asarray(setup["scales"])
    jwq = np.asarray(setup["wq"])
    assert scales.dtype == torch.float32 and all(w.dtype == torch.int8 for w in wq)
    off = 0
    for i, ((k, d), (kp, _, _)) in enumerate(zip(mrf.conv_order(KS, DILS), setup["plan"])):
        np.testing.assert_array_equal(jscales[i].reshape(R, C), np.tile(scales[i].numpy(), (R, 1)))
        t_map = _pack_plan(k, d, R)[0].astype(np.int64)
        w_wio = np.transpose(wq[i].numpy().astype(np.int64), (0, 2, 1))
        scattered = np.einsum("tbji,tcd->bjcid", t_map, w_wio).reshape(kp, 128, 128)
        np.testing.assert_array_equal(scattered, jwq[off:off + kp].astype(np.int64))
        off += kp
    assert off == jwq.shape[0]


def test_int8_reference_matches_jax_reference(setup):
    """Dynamic scales, one per batch element over the whole sequence, as
    `mrf_stage_packed_reference` takes them: bit-equal."""
    ref = jmp.mrf_stage_packed_reference(setup["x"], setup["wq"], setup["scales"], setup["biases"], KS, DILS, R,
                                         int8=True)
    np.testing.assert_array_equal(_port_stage(setup), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("t_tile,static", [(96, False), (32, True)])
def test_int8_reference_matches_packed_pallas_kernel(setup, t_tile, static):
    """K2 in interpret mode: one tile with dynamic scales (the kernel's
    per-tile scale is then the per-batch-element one), and three tiles with
    static scales (tile-independent). Bound: the JAX package's own for its
    kernel against its twin, atol = rtol = 3e-2
    (`tests/test_mrf_packed_kernel.py`); the largest error is printed."""
    act = jmp.calibrate_act_scales(setup["x"], KS, DILS, R, setup["blocks"], C) if static else None
    out = jmp.mrf_stage_packed(setup["x"], setup["wq"], setup["scales"], setup["biases"], KS, DILS, R,
                               t_tile=t_tile, int8=True, interpret=True, act_scales=act)
    out = np.asarray(out.astype(jnp.float32))
    port = _port_stage(setup, None if act is None else torch.from_numpy(np.array(act)))
    print(f"t_tile={t_tile} static={static}: max |port - pallas| = {np.abs(port - out).max()}")
    np.testing.assert_allclose(port, out, atol=3e-2, rtol=3e-2)


def test_calibrate_act_scales_match_jax(setup):
    """The port calibrates on the plain bf16 stage, JAX on its XLA packed
    path: the same absmaxes up to bf16 rounding along the chain."""
    jact = np.asarray(jmp.calibrate_act_scales(setup["x"], KS, DILS, R, setup["blocks"], C))
    act = mrf_int8.calibrate_act_scales(setup["xt"], setup["ws"], setup["bs"], KS, DILS)
    assert act.shape == (18,) and act.dtype == torch.float32
    np.testing.assert_allclose(act.numpy(), jact, rtol=2e-2)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(setup):
    wq, scales = mrf_int8.quantize_weights(setup["ws"])
    x = setup["xt"][:, :64]
    for act in (None, torch.full((18,), 2.0)):
        mrf_int8.reset_launches()
        out = mrf_int8.mrf_stage_int8(x, wq, scales, setup["bs"], KS, DILS, act)
        ref = mrf_int8.mrf_stage_int8_reference(x, wq, scales, setup["bs"], KS, DILS, act)
        assert torch.equal(out, ref) and mrf_int8.launches == {}
    with pytest.raises(ValueError, match="cpu or cuda"):
        mrf_int8.mrf_stage_int8(x.to("meta"), wq, scales, setup["bs"], KS, DILS)


def test_check_takes_bf16_activations_and_int8_weights_only(setup):
    wq, scales = mrf_int8.quantize_weights(setup["ws"])
    x, bs = setup["xt"], setup["bs"]
    mrf_int8._check(x, wq, scales, bs, KS, DILS, None)
    mrf_int8._check(x, wq, scales, bs, KS, DILS, torch.ones(18))
    bad = [
        (x.float(), wq, scales, None),
        (x, [w.to(torch.bfloat16) for w in wq], scales, None),
        (x, wq, scales.double(), None),
        (x, wq, scales, torch.ones(3)),
    ]
    for args in bad:
        with pytest.raises(TypeError):
            mrf_int8._check(args[0], args[1], args[2], bs, KS, DILS, args[3])


def test_kernel_weights_hold_the_quantized_weights_as_they_are(setup):
    """`kernel_weights` repacks nothing: the kernel's TMA boxes cut the
    [k, C_out, C_in] weights of `quantize_weights` as they are, and on the
    CPU there are no descriptors; the stage takes either form."""
    wq, scales = mrf_int8.quantize_weights(setup["ws"])
    kw = mrf_int8.kernel_weights(wq)
    assert kw.maps is None and len(kw.kernel) == len(wq)
    assert all(a is b and c is b for a, b, c in zip(kw.weights, wq, kw.kernel))
    x = setup["xt"][:, :64]
    out = mrf_int8.mrf_stage_int8(x, kw, scales, setup["bs"], KS, DILS)
    assert torch.equal(out, mrf_int8.mrf_stage_int8(x, wq, scales, setup["bs"], KS, DILS))


def test_launch_floor_counts_the_bytes_of_the_stage_launch_order():
    """`utils/roofline.py:mrf_stage_launch_bytes` against the launches that
    `ops/mrf.py:stage_launches` makes: each reads its source (and residual,
    and the running sum it adds into) and writes its output once."""
    from efficient_tts_tpu_torch.utils import roofline

    x = torch.zeros((2, 8, 32))
    passes = []

    def launch(src, i, d, res, dst, flags):
        passes.append(2 + (res is not None) + bool(flags & 2))

    mrf.stage_launches(x, len(KS), DILS, launch)
    fl = roofline.mrf_stage_launch_bytes(2, 8, 32, DILS)
    assert fl["passes"] == sum(passes) == 47 and len(passes) == 18
    assert fl["bytes"] == 47 * x.numel() * 2 and fl["absmax_bytes"] == x.numel() * 2
