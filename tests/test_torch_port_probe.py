"""Port matmul rate probe (`efficient_tts_tpu_torch/ops/probe_matmul.py`) and
the card benchmarks (`efficient_tts_tpu_torch/bench/`) on the CPU.

The probe's plain version is held against the TPU script's own `kernel`
body (`scripts/probe_int8_pallas.py`, loaded by path: `scripts/` is not a
package) run through `pl.pallas_call(..., interpret=True)` at M=4096.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from efficient_tts_tpu_torch.ops import mrf, mrf_int8
from efficient_tts_tpu_torch.ops import probe_matmul as pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 4096


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("probe_int8_pallas", os.path.join(ROOT, "scripts",
                                                                                   "probe_int8_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_probe(mod, x, w, acc_dtype):
    """The script's `make` at M rows, in interpret mode."""
    call = pl.pallas_call(
        functools.partial(mod.kernel, acc_dtype=acc_dtype, out_dtype=x.dtype),
        grid=(M // mod.TILE,),
        in_specs=[pl.BlockSpec((mod.TILE, mod.K), lambda i: (i, 0)), pl.BlockSpec((mod.K, mod.N), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((mod.TILE, mod.N), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, mod.N), x.dtype),
        interpret=True,
    )
    return np.asarray(call(x, w).astype(jnp.float32))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_reference_matches_script_kernel(script, mode):
    """int8 bit-equal, the wraps included (x, w in [-3, 3) give sums up to
    1152); bf16 within relative RMS 1e-2 (f32 sums in another order, then
    bf16 rounding 8 times)."""
    rng = np.random.default_rng(0)
    if mode == "int8":
        x, w = rng.integers(-3, 3, (M, 128)), rng.integers(-3, 3, (128, 128))
        jx, jw = jnp.asarray(x, jnp.int8), jnp.asarray(w, jnp.int8)
        tx, tw = torch.from_numpy(x).to(torch.int8), torch.from_numpy(w).to(torch.int8)
        out = _pallas_probe(script, jx, jw, jnp.int32)
    else:
        x, w = rng.standard_normal((M, 128)), 0.05 * rng.standard_normal((128, 128))
        jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (jx, jw))
        out = _pallas_probe(script, jx, jw, jnp.float32)
    ref = pm.probe_matmul_reference(tx, tw, script.REPEAT).float().numpy()
    if mode == "int8":
        assert np.abs(out).max() > 0
        np.testing.assert_array_equal(ref, out)
    else:
        assert np.sqrt(np.mean((ref - out) ** 2) / np.mean(out**2)) <= 1e-2


def test_int8_wrap_is_the_cast_of_jax():
    v = np.array([300, -300, 127, 128, -129, 1152, -1000], np.int32)
    expected = np.asarray(jnp.asarray(v).astype(jnp.int8))
    assert expected[0] == 44
    np.testing.assert_array_equal(pm.wrap_int8(torch.from_numpy(v)).numpy(), expected)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    x = torch.randint(-3, 3, (32, 128), dtype=torch.int8)
    w = torch.randint(-3, 3, (128, 128), dtype=torch.int8)
    pm.reset_launches()
    assert torch.equal(pm.probe_matmul(x, w), pm.probe_matmul_reference(x, w))
    assert pm.launches == {}
    with pytest.raises(ValueError, match="cpu or cuda"):
        pm.probe_matmul(x.to("meta"), w.to("meta"))


def test_benchmarks_run_on_the_card_only():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from efficient_tts_tpu_torch.bench import mrf_fused, probe_int8

    for main in (mrf_fused.main, probe_int8.main):
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            main([])


def test_mrf_fused_versions_on_the_cpu():
    """The bench's inputs at a tiny size (B=1, M=8 packed blocks -> T=32 at
    ch=32): the script's packed input reshaped, and each version's plain
    route; the cuDNN-stage version is the plain bf16 stage up to the conv's
    rounding to bf16 before the bias."""
    from efficient_tts_tpu_torch.bench import mrf_fused

    st = mrf_fused.make_stage(1, 8, 32, "cpu")
    x = np.array(torch.from_numpy(0.5 * np.random.default_rng(0).standard_normal((1, 8, 128))).to(torch.bfloat16)
                 .float())
    np.testing.assert_array_equal(st["x"].float().numpy().reshape(1, 8, 128), x)
    assert st["act_scales"].shape == (18,) and len(st["wq"]) == 18
    outs = {name: fn() for name, fn in mrf_fused.versions(st).items()}
    ks, ds = mrf_fused.KS, mrf_fused.DILS
    assert torch.equal(outs["kernel bf16"], mrf.mrf_stage_reference(st["x"], st["w_bf16"], st["biases"], ks, ds))
    assert torch.equal(outs["kernel int8-static"], mrf_int8.mrf_stage_int8_reference(
        st["x"], st["wq"], st["scales"], st["biases"], ks, ds, st["act_scales"]))
    dev = mrf_fused.deviations(outs)
    ref = outs["cudnn bf16"].float()
    assert outs["cudnn bf16"].shape == st["x"].shape
    assert dev["kernel bf16"] <= 2**-4 * float(ref.abs().max())


def test_probe_inputs_and_library_chain_on_the_cpu():
    from efficient_tts_tpu_torch.bench import probe_int8

    ins = probe_int8.make_inputs(64, "cpu")
    assert [(x.dtype, w.dtype) for x, w in ins.values()] == [(torch.bfloat16,) * 2, (torch.int8,) * 2]
    x, w = ins["int8"]
    assert torch.equal(probe_int8.library_chain(x, w), pm.probe_matmul_reference(x, w))
