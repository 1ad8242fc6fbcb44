"""Port synthesis path end to end against the JAX package, on the CPU.

A tiny EFTS-CNN and a tiny V1-shaped generator (upsample_initial_channel=32,
kernels 3/7/11, dilations 1/3/5) get seeded numpy weights in the JAX
package's tree layout (`efficient_tts_tpu_torch/init.py`, whose keys and
shapes `test_init_matches_jax_tree` holds against the JAX init); the same
trees feed the JAX functions and, through the bridge, the port. The duration
head's bias is raised so random weights give durations of a few frames per
token rather than zero.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu.models import efficient_tts as efts
from efficient_tts_tpu.models import hifigan as hg
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.nn.layers import fold_weight_norm

EFTS_CFG = EftsCNNConfig(num_symbols=40, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=2,
                         n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0, use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32)


def _jax_cfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


J_EFTS, J_VOC = _jax_cfg(efts.EftsCNNConfig, EFTS_CFG), _jax_cfg(hg.HiFiGANConfig, VOC_CFG)


@pytest.fixture(scope="module")
def models():
    ep = init.init_efts(0, EFTS_CFG)
    ep["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
    vp = init.init_generator(1, VOC_CFG)
    return (ep, vp, compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu"),
            compat.hifigan_generator_from_jax(vp, VOC_CFG, device="cpu"))


def _text(b=3, t1=14, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([t1, 9, 5][:b], np.int32)
    text = np.zeros((b, t1), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, 40, n)
    return text, lengths


def test_infer_durations_and_decode_f32(models):
    """f32 end to end through stage 1 and the mel decode: rtol 1e-5 covers f32
    sums in another order (the e cumsum reaches ~50 frames)."""
    ep, _, em, _ = models
    text, lengths = _text()
    e_j, v_j, tm_j = efts.infer_durations(ep, J_EFTS, jnp.asarray(text), jnp.asarray(lengths))
    mel_j, alpha_j = efts.infer_decode(ep, J_EFTS, v_j, e_j, tm_j, 64)
    with torch.no_grad():
        e_t, v_t, tm_t = em.infer_durations(torch.from_numpy(text).long(), torch.from_numpy(lengths).long())
        mel_t, alpha_t = em.infer_decode(v_t, e_t, tm_t, 64)
    assert float(e_t.max()) > 10  # durations are not degenerate
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("duration_correction", [False, True, 0.0])
def test_synthesize_fixed_f32(models, duration_correction):
    """wav, mel and exact wav_lengths against `synthesize_fixed(..., mrf_impl=
    "xla")`, whose packed layouts are exact re-layouts of the plain math:
    atol 1e-5 on a waveform in (-1, 1) covers f32 reassociation over ~30
    convs (measured 2e-7)."""
    ep, vp, em, vm = models
    text, lengths = _text()
    wav_j, wl_j, mel_j = jpipe.synthesize_fixed(
        ep, vp, text, lengths, J_EFTS, J_VOC, 64, mrf_impl="xla", duration_correction=duration_correction)
    wav_t, wl_t, mel_t = pipeline.synthesize_fixed(
        em, vm, text, lengths, 64, duration_correction=duration_correction, device="cpu")
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_j))
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), rtol=0, atol=1e-5)
    assert wav_t.shape == (3, 64 * 256)


def test_synthesize_fixed_bf16(models):
    """bf16 decoder and vocoder. The port's MRF stages round once after the
    bias where XLA rounds twice, and the two sides' bf16 convs differ in
    accumulation, so the bound is a loose one: RMS error <= 5% of the
    waveform's RMS, max error <= 0.1 of its range (measured 0.13% and
    0.75%); lengths exact (stage 1 is f32)."""
    ep, vp, em, vm = models
    text, lengths = _text()
    wav_j, wl_j, _ = jpipe.synthesize_fixed(
        ep, vp, text, lengths, J_EFTS, J_VOC, 64, compute_dtype=jnp.bfloat16, mrf_impl="xla")
    wav_t, wl_t, _ = pipeline.synthesize_fixed(
        em, vm, text, lengths, 64, compute_dtype=torch.bfloat16, device="cpu")
    ref, out = np.asarray(wav_j), wav_t.numpy()
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_j))
    assert np.all(np.isfinite(out))
    err = np.abs(out - ref)
    assert np.sqrt(np.mean(err**2) / np.mean(ref**2)) <= 0.05
    assert err.max() <= 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("output", ["f32", "pcm16"])
def test_synthesize_end_to_end(models, output):
    """Host bucket choice from the stage-1 readback: the same bucket and the
    same wav_lengths as JAX; samples agree to 1e-4 (f32) or 1 LSB (pcm16,
    where an f32 difference can flip one rounding)."""
    ep, vp, em, vm = models
    text, lengths = _text()
    wav_j, wl_j = jpipe.synthesize(ep, vp, text, lengths, J_EFTS, J_VOC, bucket_multiple=32,
                                   mrf_impl="xla", output=output)
    wav_t, wl_t = pipeline.synthesize(em, vm, text, lengths, bucket_multiple=32, output=output,
                                      device="cpu")
    assert wav_t.shape == wav_j.shape and wav_t.dtype == wav_j.dtype
    np.testing.assert_array_equal(wl_t, wl_j)
    assert wl_t.dtype == np.int32
    tol = 1 if output == "pcm16" else 1e-4
    assert np.abs(wav_t.astype(np.float64) - wav_j.astype(np.float64)).max() <= tol
    for i, n in enumerate(wl_t):
        assert np.all(wav_t[i, n:] == 0)


def test_predict_lengths(models):
    ep, _, em, _ = models
    text, lengths = _text()
    ref = np.asarray(jpipe.predict_lengths(ep, text, lengths, J_EFTS))
    out = pipeline.predict_lengths(em, text, lengths, device="cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_bridge_accepts_folded_params(models):
    """{w, b} (weight norm already folded by the JAX package) and {v, g, b}
    give the same port modules."""
    ep, vp, em, vm = models
    from efficient_tts_tpu.nn.layers import fold_weight_norm as jax_fold

    em2 = compat.efts_cnn_from_jax(jax.tree_util.tree_map(np.asarray, jax_fold(ep)), EFTS_CFG, device="cpu")
    vm2 = compat.hifigan_generator_from_jax(jax.tree_util.tree_map(np.asarray, jax_fold(vp)), VOC_CFG,
                                            device="cpu")
    for a, b in ((em, em2), (vm, vm2)):
        for (na, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
            if not na.endswith("_bf16"):  # the bf16 copies are made from these
                torch.testing.assert_close(ta, tb, rtol=1e-6, atol=1e-7, msg=na)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("full", [False, True])
def test_init_matches_jax_tree(full):
    """The port's numpy init has the JAX init's keys and shapes (the full
    widths are checked with `jax.eval_shape`, which computes nothing)."""
    ecfg = EftsCNNConfig(num_symbols=76) if full else EFTS_CFG
    vcfg = HiFiGANConfig() if full else VOC_CFG
    key = jax.random.PRNGKey(0)
    je = jax.eval_shape(lambda: efts.init(key, _jax_cfg(efts.EftsCNNConfig, ecfg)))
    jv = jax.eval_shape(lambda: hg.init_generator(key, _jax_cfg(hg.HiFiGANConfig, vcfg)))
    assert _shapes(init.init_efts(0, ecfg)) == jax.tree_util.tree_map(lambda s: s.shape, je)
    pv = init.init_generator(1, vcfg)
    assert _shapes(pv) == jax.tree_util.tree_map(lambda s: s.shape, jv)
    # folded generator weights have N(0, 0.01) statistics in the resblocks
    w = fold_weight_norm(pv)["resblocks"][0]["convs1"][0]["w"]
    assert abs(float(w.std()) - 0.01) < 0.002
