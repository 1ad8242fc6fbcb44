"""Port primitives, res-conv block, duration predictor and alignment against JAX.

Parameters and inputs come from numpy seeds (or the JAX package's own init)
and go through both the JAX function and its port on the CPU in f32. The
tolerance, rtol = atol = 1e-5, covers f32 sums taken in another order by
XLA's and PyTorch's CPU kernels; the bf16 checks are exact, because both
sides round at the same points.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficient_tts_tpu.models import efficient_tts as efts
from efficient_tts_tpu.nn import layers as jl
from efficient_tts_tpu.nn.blocks import res_conv_block
from efficient_tts_tpu.nn.duration_predictor import duration_predictor_infer
from efficient_tts_tpu.ops import alignment as jal
from efficient_tts_tpu.utils import masks as jmasks
from efficient_tts_tpu_torch import compat
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.nn import layers as tl
from efficient_tts_tpu_torch.ops import alignment as tal
from efficient_tts_tpu_torch.utils import masks as tmasks

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_linear_embedding_layer_norm():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((12, 7)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    x = _x((2, 5, 12))
    np.testing.assert_allclose(tl.linear(_t(x), _t(p["w"].T), _t(p["b"])).numpy(),
                               np.asarray(jl.linear(p, jnp.asarray(x))), **TOL)
    table = _x((9, 4), 1)
    ids = rng.integers(0, 9, (2, 6))
    np.testing.assert_array_equal(
        torch.nn.functional.embedding(torch.from_numpy(ids), _t(table)).numpy(),
        np.asarray(jl.embedding({"table": table}, jnp.asarray(ids))))
    scale, bias = _x((12,), 2), _x((12,), 3)
    # tiny variance rows: the 1e-12 eps (not torch's 1e-5) decides the result
    xs = np.concatenate([x, 1e-4 * x], axis=0)
    np.testing.assert_allclose(tl.layer_norm(_t(xs), _t(scale), _t(bias)).numpy(),
                               np.asarray(jl.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(xs))),
                               **TOL)


@pytest.mark.parametrize("k,d", [(5, 1), (3, 3), (7, 1), (11, 5)])
def test_conv1d(k, d):
    rng = np.random.default_rng(k)
    w = (0.3 * rng.standard_normal((k, 6, 8))).astype(np.float32)  # WIO
    b = rng.standard_normal(8).astype(np.float32)
    x = _x((2, 30, 6))
    ref = jl.conv1d({"w": w, "b": b}, jnp.asarray(x), dilation=d)
    out = tl.conv1d(_t(x), _t(np.transpose(w, (2, 1, 0))), _t(b), dilation=d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("u,k", [(8, 16), (2, 4)])
def test_conv_transpose1d(u, k):
    rng = np.random.default_rng(u)
    w = (0.3 * rng.standard_normal((k, 6, 4))).astype(np.float32)  # WIO
    b = rng.standard_normal(4).astype(np.float32)
    x = _x((2, 9, 6))
    pad = (k - u) // 2
    ref = np.asarray(jl.conv_transpose1d({"w": w, "b": b}, jnp.asarray(x), u, pad))
    out = tl.conv_transpose1d(_t(x), _t(np.transpose(w, (1, 2, 0))), _t(b), u, pad).numpy()
    assert out.shape == ref.shape == (2, 9 * u, 4)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("preserved_axis", [-1, 1])
def test_fold_weight_norm(preserved_axis):
    """Conv/linear weight norm keeps the output axis; a transposed conv's
    keeps the input axis (axis 1 in WIO)."""
    rng = np.random.default_rng(0)
    p = jl.weight_norm_init({"w": jnp.asarray(_x((5, 6, 7))), "b": jnp.zeros(7)}, preserved_axis)
    p["g"] = p["g"] * jnp.asarray(rng.uniform(0.5, 2.0, p["g"].shape), jnp.float32)
    ref = _np(jl.fold_weight_norm(p))
    out = tl.fold_weight_norm(_np(p))
    np.testing.assert_allclose(out["w"], ref["w"], **TOL)
    # an already folded {w, b} passes through unchanged
    np.testing.assert_array_equal(tl.fold_weight_norm(ref)["w"], ref["w"])


def test_leaky_relu_f32_and_bf16_exact():
    x = jnp.asarray(_x((4, 33)) * 3)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jl.leaky_relu(x.astype(dt), 0.1).astype(jnp.float32))
        out = tl.leaky_relu(torch.from_numpy(np.array(x.astype(dt).astype(jnp.float32))).to(tdt), 0.1)
        np.testing.assert_array_equal(out.float().numpy(), ref)


CFG = EftsCNNConfig(num_symbols=30, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=2,
                    n_decoder_layer=2, dropout_rate=0.0, use_masking=True)


@pytest.fixture(scope="module")
def efts_pair():
    jcfg = efts.EftsCNNConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
    params = _np(efts.init(jax.random.PRNGKey(3), jcfg))
    return params, compat.efts_cnn_from_jax(params, CFG, device="cpu")


def test_res_conv_block(efts_pair):
    params, model = efts_pair
    x = _x((2, 17, 24))
    ref = np.asarray(res_conv_block(params["text_encoder"], jnp.asarray(x), CFG.leaky_slope))
    with torch.no_grad():
        out = model.text_encoder(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_duration_predictor_infer(efts_pair):
    params, model = efts_pair
    x = _x((2, 11, 24))
    lengths = np.array([11, 6])
    pad = ~np.asarray(jmasks.sequence_mask(jnp.asarray(lengths), 11))
    ref = np.asarray(duration_predictor_infer(params["duration_predictor"], jnp.asarray(x),
                                              pad_mask=jnp.asarray(pad), offset=1.0))
    with torch.no_grad():
        out = model.duration_predictor.infer(_t(x), pad_mask=torch.from_numpy(pad), offset=1.0).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[1, 6:] == 0) and np.all(out >= 0)


def test_masks():
    lengths = np.array([3, 0, 7])
    np.testing.assert_array_equal(tmasks.sequence_mask(torch.from_numpy(lengths), 7).numpy(),
                                  np.asarray(jmasks.sequence_mask(jnp.asarray(lengths), 7)))
    for n, m in ((1, 64), (64, 64), (65, 64), (300, 32), (10, 32)):
        assert tmasks.bucket_length(n, m) == jmasks.bucket_length(n, m)


@pytest.mark.parametrize("with_text_mask", [True, False])
def test_alignment_from_positions(with_text_mask):
    rng = np.random.default_rng(0)
    e = np.cumsum(rng.uniform(0.0, 4.0, (2, 9)), axis=1).astype(np.float32)
    lengths = np.array([9, 5])
    tm = np.array(jmasks.sequence_mask(jnp.asarray(lengths), 9))
    kw_j = dict(text_mask=jnp.asarray(tm)) if with_text_mask else {}
    kw_t = dict(text_mask=torch.from_numpy(tm)) if with_text_mask else {}
    ref = np.asarray(jal.alignment_from_positions(jnp.asarray(e), 40, sigma=0.01, **kw_j))
    out = tal.alignment_from_positions(_t(e), 40, sigma=0.01, **kw_t).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    mel_mask = np.arange(40)[None, :] < np.array([[40], [25]])
    ref = np.asarray(jal.alignment_from_positions(jnp.asarray(e), 40, mel_mask=jnp.asarray(mel_mask), **kw_j))
    out = tal.alignment_from_positions(_t(e), 40, mel_mask=torch.from_numpy(mel_mask), **kw_t).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_masked_softmax_fully_masked_row_is_zero():
    s = _x((2, 3, 5))
    mask = np.ones((2, 3, 5), bool)
    mask[1, 2] = False
    out = tal.masked_softmax(_t(s), torch.from_numpy(mask), dim=-1).numpy()
    np.testing.assert_allclose(out, np.asarray(jal.masked_softmax(jnp.asarray(s), jnp.asarray(mask), -1)), **TOL)
    assert np.all(out[1, 2] == 0) and np.all(np.isfinite(out))


@pytest.mark.parametrize("thresh", [0.0, 0.02, 0.5])
def test_boundary_truncation_correction(thresh):
    rng = np.random.default_rng(1)
    e = np.cumsum(rng.uniform(0.5, 3.0, (3, 8)), axis=1).astype(np.float32)
    lengths = np.array([8, 3, 5])
    ref = np.asarray(jal.boundary_truncation_correction(jnp.asarray(e), jnp.asarray(lengths), 0.5,
                                                        rel_threshold=thresh))
    out = tal.boundary_truncation_correction(_t(e), torch.from_numpy(lengths), 0.5,
                                             rel_threshold=thresh).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
