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


# ---------------------------------------------------------------------------
# The card kernel's index maps (csrc/probe_matmul.cu), emulated: a warpgroup's
# accumulator fragments, the A registers the kernel packs from them, the
# shared copies of w it writes (128-byte swizzle; in int8 also with k
# permuted), and its swizzled output tile as the TMA store reads it. The
# registers are decoded by the wgmma A-fragment layouts (bf16 m64nNk16, s8
# m64nNk32: per warp the mma.sync m16n8k16 / m16n8k32 A layouts) and the
# shared copies by the swizzle the B descriptor reads through; the products
# must equal the plain ones.


def _int8_logical_k(k):
    """probe_matmul.cu:int8_logical_k"""
    p = k & 31
    h, q = p >> 4, p & 15
    tig, b = (q if q < 8 else q - 8) >> 1, (q & 1) + (0 if q < 8 else 2)
    return (k & ~31) + 16 * h + 4 * tig + b


def _sw128(row, c):
    """probe_matmul.cu:sw128, and the address the hardware reads for byte c of
    row `row` of a 128-byte-swizzled tile on a 1024-byte boundary"""
    return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15)


def _threads():
    """(thread, warp, g, t) of a warpgroup's 128 threads."""
    for tid in range(128):
        lane = tid & 31
        yield tid, tid >> 5, lane >> 2, lane & 3


def _fragments(acc):
    """d[tid][4j + 2h + e] = acc[16w + g + 8h, 8j + 2t + e]: the wgmma m64n128
    accumulator layout (sm90_common.cuh:wgmma_ss)."""
    d = np.zeros((128, 64), acc.dtype)
    for tid, w, g, t in _threads():
        for j in range(16):
            for h in range(2):
                for e in range(2):
                    d[tid, 4 * j + 2 * h + e] = acc[16 * w + g + 8 * h, 8 * j + 2 * t + e]
    return d


def _pack_a(d, int8):
    """The kernel's conversion of one thread's accumulators into the A
    registers of the next product, as element lists per (k step, register)."""
    if int8:
        return [[[q[0], q[1], q[4], q[5]], [q[2], q[3], q[6], q[7]], [q[8], q[9], q[12], q[13]],
                 [q[10], q[11], q[14], q[15]]] for q in (d[16 * ks:16 * ks + 16] for ks in range(4))]
    return [[list(q[0:2]), list(q[2:4]), list(q[4:6]), list(q[6:8])] for q in (d[8 * ks:8 * ks + 8] for ks in range(8))]


def _decode_a(regs, int8):
    """The [64, 128] A operand the wgmma reads from every thread's registers:
    register i holds row g + 8 (i % 2) of its warp's 16 and, in a k step of
    32 bytes, k = 4t + 16 (i // 2) + e (s8) or 2t + 8 (i // 2) + e (bf16)."""
    a = np.zeros((64, 128), np.float64)
    step, per = (32, 4) if int8 else (16, 2)
    for tid, w, g, t in _threads():
        for ks, rk in enumerate(regs[tid]):
            for i, elems in enumerate(rk):
                for e, v in enumerate(elems):
                    a[16 * w + g + 8 * (i % 2), ks * step + per * t + (16 if int8 else 8) * (i // 2) + e] = v
    return a


def _w_copy(w, int8):
    """The kernel's shared copy of w (B, [N][K] K-major, 128-byte swizzle):
    int8 natural then permuted, 16 KB each; bf16 two 16 KB column blocks.
    Returns {offset: element}; every offset is written once."""
    smem = {}
    for k in range(128):
        for n in range(128):
            if int8:
                offs = (_sw128(n, k), 16384 + _sw128(n, _int8_logical_k(k)))
            else:
                offs = ((k >> 6) * 16384 + _sw128(n, (k & 63) * 2),)
            for o in offs:
                assert o not in smem
                smem[o] = w[k, n]
    return smem


def _decode_b(smem, int8, perm):
    """The [N, K] B operand the descriptors of the k steps read: k step ks
    starts at byte ks*32 of the row (int8: of copy `perm`; bf16: in column
    block ks // 4)."""
    b = np.zeros((128, 128), np.float64)
    for n in range(128):
        for k in range(128):
            if int8:
                b[n, k] = smem[perm * 16384 + _sw128(n, k)]
            else:
                ks, kk = divmod(k, 16)
                b[n, k] = smem[(ks >> 2) * 16384 + _sw128(n, (ks & 3) * 32 + 2 * kk)]
    return b


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_card_kernel_index_maps_leave_the_products_unchanged(mode):
    int8 = mode == "int8"
    rng = np.random.default_rng(1)
    w = rng.integers(-3, 3, (128, 128)).astype(np.float64)
    smem = _w_copy(w, int8)
    assert len(smem) == (2 if int8 else 1) * 128 * 128
    # the first product reads w in natural order
    np.testing.assert_array_equal(_decode_b(smem, int8, 0), w.T)
    # products 2..8: A from the accumulator of the product before
    if int8:
        acc = rng.integers(-3000, 3000, (64, 128)).astype(np.int32)
        a_vals = pm.wrap_int8(torch.from_numpy(acc)).numpy().astype(np.float64)
        regs = [_pack_a(pm.wrap_int8(torch.from_numpy(d)).numpy(), True) for d in _fragments(acc)]
    else:
        acc = rng.standard_normal((64, 128)).astype(np.float32)
        a_vals = torch.from_numpy(acc).to(torch.bfloat16).double().numpy()
        regs = [_pack_a(torch.from_numpy(d).to(torch.bfloat16).double().numpy(), False) for d in _fragments(acc)]
    a = _decode_a(regs, int8)
    b = _decode_b(smem, int8, 1 if int8 else 0)
    if int8:
        # the registers hold k permuted, and the permuted copy of w alike
        perm = np.array([_int8_logical_k(k) for k in range(128)])
        np.testing.assert_array_equal(a[:, perm], a_vals)
        assert sorted(perm.tolist()) == list(range(128))
    else:
        np.testing.assert_array_equal(a, a_vals)
    np.testing.assert_array_equal(a @ b.T, a_vals @ w)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_card_kernel_output_tile_is_the_accumulator(mode):
    """The epilogue's writes into the swizzled output tile, read back as the
    TMA store reads its boxes (64 columns of bf16, or 128 int8, per box),
    give the accumulator in row-major order."""
    int8 = mode == "int8"
    acc = np.arange(64 * 128).reshape(64, 128)
    tile, frags = {}, _fragments(acc)
    for tid, w, g, t in _threads():
        d = frags[tid]
        for j in range(16):
            for h in range(2):
                r = 16 * w + g + 8 * h
                if int8:
                    offs = [_sw128(r, 8 * j + 2 * t) + e for e in range(2)]
                else:
                    base = (j >> 3) * 64 * 128 + _sw128(r, ((8 * j) & 63) * 2 + 4 * t)
                    offs = [base + 2 * e for e in range(2)]
                for e, o in enumerate(offs):
                    assert o not in tile
                    tile[o] = d[4 * j + 2 * h + e]
    elem = 1 if int8 else 2
    out = np.array([[tile[(c * elem // 128) * 64 * 128 + _sw128(r, (c * elem) % 128)] for c in range(128)]
                    for r in range(64)])
    np.testing.assert_array_equal(out, acc)
