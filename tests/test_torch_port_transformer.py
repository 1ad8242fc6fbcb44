"""Port EFTS-Transformer synthesis against the JAX package, on the CPU.

A small EFTS-Transformer (width 64, 2 heads so dk = 32, ff 128, 2 text
encoder and 2 decoder layers, conv feed-forward k = 3) gets seeded numpy
weights in the JAX package's tree layout (`init.init_efts_transformer`);
the same tree feeds the JAX functions and, through the bridge, the port.
The duration head's bias is raised so random weights give about 1.4 frames
per token, and `pe_scale` is set to 0.7 so the bridge's copy of it counts.

Both attention paths are covered, each at a ragged T1 = 128 (every call
eligible for flash: segment-id semantics) and T1 = 96 (no call eligible:
the XLA branch under either setting), with t2 = 256 and 192. JAX's flash
kernel runs only on a TPU, so for "flash" the JAX side runs its library's
plain reference `mha_reference_no_custom_vjp` with the same segment ids,
patched in for the test only; the model functions are called unjitted, so
no jit cache keeps a patched trace. Tolerances are f32 ones: rtol = atol =
1e-5 on activations of range about 2, 1e-4 on `e`, which reaches a few
hundred frames after a cumsum.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

import efficient_tts_tpu.nn.attention as jattn
from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu.models import efficient_tts_transformer as jt
from efficient_tts_tpu.models import hifigan as hg
from efficient_tts_tpu.nn import transformer as jtr
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.models import MODEL_REGISTRY, model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer, EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.nn import attention as tattn
from efficient_tts_tpu_torch.nn.transformer import TransformerBlock
from efficient_tts_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = EftsTransformerConfig(num_symbols=40, n_channels=64, n_heads=2, ff_hidden=128, n_text_encoder_layer=2,
                            n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32)
J_VOC = hg.HiFiGANConfig(**dataclasses.asdict(VOC_CFG))
# (attn_impl, T1, t2): eligible and ineligible buckets on both paths
CASES = [("flash", 128, 256), ("flash", 96, 192), ("xla", 128, 256), ("xla", 96, 192)]


def _jcfg(cfg):
    return jt.EftsTransformerConfig(**dataclasses.asdict(cfg))


def _patched_flash(q, k, v, mask, dk):
    """`_flash_attention` with the library's plain reference in place of the
    TPU kernel: the same segment ids and scale."""
    seg = None
    if mask is not None:
        ids = mask[:, 0, :].astype(jnp.int32)
        seg = JSegmentIds(q=ids, kv=ids)
    return mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=1.0 / float(np.sqrt(dk)))


@pytest.fixture(autouse=True)
def _jax_flash_on_cpu(monkeypatch):
    monkeypatch.setattr(jattn, "_flash_attention", _patched_flash)


@pytest.fixture(scope="module")
def params():
    p = init.init_efts_transformer(0, CFG)
    p["duration_predictor"]["out"]["b"] = np.full((1,), 0.5, np.float32)
    p["pe_scale"] = np.float32(0.7)
    return p


@pytest.fixture(scope="module")
def vocoder():
    vp = init.init_generator(1, VOC_CFG)
    return vp, compat.hifigan_generator_from_jax(vp, VOC_CFG, device="cpu")


def _model(params, impl):
    cfg = dataclasses.replace(CFG, attn_impl=impl)
    return cfg, compat.efts_transformer_from_jax(params, cfg, device="cpu")


def _text(t1, b=3, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([t1, t1 - 28, t1 // 2][:b], np.int32)
    text = np.zeros((b, t1), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, CFG.num_symbols, n)
    return text, lengths


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------------------
# positional encoding, the flash function's plain version, attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positional_encoding_matches_jax(dtype):
    """The float64 table cast once, `pe * scale` in x's dtype: exact."""
    x = _x((2, 50, 64))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jattn.add_positional_encoding(jx, scale=jnp.asarray(0.7, jnp.float32).astype(jx.dtype))
    out = tattn.add_positional_encoding(tx, scale=torch.tensor(0.7).to(tx.dtype))
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(tattn.positional_encoding(37, 10).numpy(),
                                  np.asarray(jattn.positional_encoding(37, 10)))


@pytest.mark.parametrize("dk", [32, 96])
@pytest.mark.parametrize("segmented", [False, True])
def test_flash_reference_matches_library_reference(dk, segmented):
    """`flash_attention_reference` against `mha_reference_no_custom_vjp`, f32,
    scores of a few units (q, k ~ N(0, 1), sm_scale 1/sqrt(dk)); ragged segments
    with one row all valid; rtol = atol = 1e-5."""
    b, h, t = 3, 2, 128
    q, k, v = (_x((b, h, t, dk), s) for s in (1, 2, 3))
    seg_j = seg_t = None
    if segmented:
        ids = (np.arange(t)[None, :] < np.array([128, 100, 37])[:, None]).astype(np.int32)
        seg_j = JSegmentIds(q=jnp.asarray(ids), kv=jnp.asarray(ids))
        seg_t = tfa.SegmentIds(torch.from_numpy(ids), torch.from_numpy(ids))
    scale = 1.0 / float(np.sqrt(dk))
    ref = mha_reference_no_custom_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=seg_j,
                                      sm_scale=scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(tfa.flash_attention_reference(tq, tk, tv, seg_t, scale), ref)
    # the wrapper takes the plain version for CPU tensors and counts no launch
    tfa.reset_launches()
    _close(tfa.flash_attention(tq, tk, tv, seg_t, scale), ref)
    assert tfa.launches == {}


def test_flash_attention_rejects_other_devices():
    x = torch.zeros((1, 1, 64, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(x, x, x)


def _attn_params(d, seed):
    rng = np.random.default_rng(seed)
    return {n: {"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(d)).astype(np.float32)} for n in ("q", "k", "v", "out")}


@pytest.mark.parametrize("impl,t,masked", [
    ("flash", 128, True), ("flash", 128, False), ("flash", 96, True),
    ("xla", 128, True), ("xla", 96, True), ("auto", 128, True), ("flash_plain", 128, True)])
def test_attention_matches_jax(impl, t, masked):
    """`MultiHeadAttention` against `multi_head_attention` on the same weights,
    every row compared (pad rows too, where the two semantics differ), f32.
    "auto" is the XLA branch on the CPU on both sides; the port's
    "flash_plain" is JAX's "flash" path."""
    d, n_head = 64, 2
    p = _attn_params(d, t)
    x = _x((3, t, d), 7)
    lengths = np.array([t, t - 28, 20])
    mask = (np.arange(t)[None, :] < lengths[:, None])[:, None, :] if masked else None
    ref = jattn.multi_head_attention(p, *(jnp.asarray(x),) * 3, n_head,
                                     mask=None if mask is None else jnp.asarray(mask),
                                     impl="flash" if impl == "flash_plain" else impl)
    mod = tattn.MultiHeadAttention(d, n_head)
    with torch.no_grad():
        for n in ("q", "k", "v", "out"):
            getattr(mod, n).weight.copy_(torch.from_numpy(p[n]["w"].T))
            getattr(mod, n).bias.copy_(torch.from_numpy(p[n]["b"]))
        out = mod(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), impl=impl)
    _close(out, ref)


@pytest.mark.parametrize("tq,tk,mask_shape,eligible", [
    (256, 256, (2, 1, 256), True), (256, 256, None, True), (200, 200, (2, 1, 200), False),
    (256, 128, (2, 1, 128), False), (256, 256, (2, 256, 256), False)])
def test_flash_eligible_matches_jax(tq, tk, mask_shape, eligible):
    mask = None if mask_shape is None else np.ones(mask_shape, bool)
    assert jattn._flash_eligible(tq, tk, mask, 0.0, True) is eligible
    assert tattn.flash_eligible(tq, tk, None if mask is None else torch.from_numpy(mask)) is eligible


@pytest.mark.parametrize("use_conv_ff", [True, False])
def test_transformer_block_matches_jax(use_conv_ff):
    """Pre-norm layers and the final norm, the conv or the linear
    feed-forward, a ragged key-padding mask, f32."""
    cfg = dataclasses.replace(CFG, use_conv_ff=use_conv_ff)
    p = init.init_efts_transformer(3, cfg)["text_encoder"]
    rng = np.random.default_rng(1)
    for lp in p["layers"]:  # non-trivial norms
        for n in ("norm1", "norm2"):
            lp[n] = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    x = _x((2, 96, 64), 5)
    mask = (np.arange(96)[None, :] < np.array([96, 50])[:, None])[:, None, :]
    ref = jtr.transformer_block(p, jnp.asarray(x), cfg.n_heads, mask=jnp.asarray(mask), use_conv_ff=use_conv_ff)
    block = TransformerBlock(cfg.n_text_encoder_layer, 64, cfg.n_heads, cfg.ff_hidden, use_conv_ff)
    compat._load_transformer_block(block, p)
    with torch.no_grad():
        _close(block(torch.from_numpy(x), torch.from_numpy(mask)), ref)


# ---------------------------------------------------------------------------
# the model and the pipeline


@pytest.mark.parametrize("impl,t1,t2", CASES)
def test_infer_durations_and_decode_match_jax(params, impl, t1, t2):
    """e, the text value and the f32 mel against `infer_durations` /
    `infer_decode` (unjitted)."""
    cfg, model = _model(params, impl)
    jcfg = _jcfg(cfg)
    text, lengths = _text(t1)
    e_j, v_j, tm_j = jt.infer_durations(params, jcfg, jnp.asarray(text), jnp.asarray(lengths))
    mel_j, alpha_j = jt.infer_decode(params, jcfg, v_j, e_j, tm_j, t2)
    with torch.no_grad():
        e_t, v_t, tm_t = model.infer_durations(torch.from_numpy(text).long(), torch.from_numpy(lengths).long())
        mel_t, alpha_t = model.infer_decode(v_t, e_t, tm_t, t2)
    assert 0.5 * t2 < float(e_t.max()) < t2  # durations are not degenerate and fit the bucket
    _close(e_t, e_j, rtol=1e-5, atol=1e-4)
    _close(v_t, v_j)
    _close(alpha_t, alpha_j, rtol=1e-4, atol=1e-5)
    _close(mel_t, mel_j)


def test_flash_and_xla_differ_on_a_ragged_eligible_batch(params):
    """On a ragged T1 = 128 batch the two semantics give different valid rows,
    in JAX and in the port alike: pad rows leak into the last valid rows
    through the conv feed-forward, one row per layer, and attention spreads
    that over the utterance. Measured: 0.09 at the last valid row, 4e-4 at
    the others, on a range of 2.1, identically on both sides. The bound here
    is 1e-2 at the last valid row, far above the f32 tolerance; the
    utterance without padding agrees within it."""
    text, lengths = _text(128)
    values = {}
    for impl in ("flash", "xla"):
        cfg, model = _model(params, impl)
        _, v_j, _ = jt.infer_durations(params, _jcfg(cfg), jnp.asarray(text), jnp.asarray(lengths))
        with torch.no_grad():
            _, v_t, _ = model.infer_durations(torch.from_numpy(text).long(), torch.from_numpy(lengths).long())
        values[impl] = (np.asarray(v_j), v_t.numpy())
    for side in (0, 1):  # JAX, port
        flash, xla = values["flash"][side], values["xla"][side]
        for i in (1, 2):
            assert np.abs(flash[i, lengths[i] - 1] - xla[i, lengths[i] - 1]).max() > 1e-2
        np.testing.assert_allclose(flash[0], xla[0], **TOL)
    np.testing.assert_allclose(values["flash"][1] - values["xla"][1], values["flash"][0] - values["xla"][0], **TOL)


@pytest.mark.parametrize("impl,t1,t2", CASES)
def test_synthesize_fixed_matches_jax(params, vocoder, impl, t1, t2):
    """Waveform, mel and exact wav_lengths through a tiny V1-shaped vocoder,
    against the unjitted body of the JAX `synthesize_fixed` (mrf_impl="xla"),
    f32: atol 1e-5 on a waveform in (-1, 1)."""
    vp, voc = vocoder
    cfg, model = _model(params, impl)
    text, lengths = _text(t1)
    wav_j, wl_j, mel_j = jpipe.synthesize_body(params, vp, jnp.asarray(text), jnp.asarray(lengths), _jcfg(cfg),
                                               J_VOC, t2, mrf_impl="xla")
    wav_t, wl_t, mel_t = pipeline.synthesize_fixed(model, voc, text, lengths, t2, device="cpu")
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_j))
    _close(mel_t, mel_j)
    _close(wav_t, wav_j, rtol=0, atol=1e-5)
    assert wav_t.shape == (3, t2 * VOC_CFG.hop_size)


def test_synthesize_fixed_bf16_matches_jax(params, vocoder):
    """bf16 decode and vocoder on the flash path. The decoder's first
    LayerNorm brings the bf16 expansion back to f32 on both sides, so the
    differences come from the vocoder's bf16 convs (see the EFTS-CNN bf16
    test): RMS error <= 5% of the waveform's RMS, max error <= 0.1 of its
    range; lengths exact (stage 1 is f32)."""
    vp, voc = vocoder
    cfg, model = _model(params, "flash")
    text, lengths = _text(128)
    wav_j, wl_j, _ = jpipe.synthesize_body(params, vp, jnp.asarray(text), jnp.asarray(lengths), _jcfg(cfg),
                                           J_VOC, 256, compute_dtype=jnp.bfloat16, mrf_impl="xla")
    wav_t, wl_t, _ = pipeline.synthesize_fixed(model, voc, text, lengths, 256, compute_dtype=torch.bfloat16,
                                               device="cpu")
    ref, out = np.asarray(wav_j), wav_t.numpy()
    np.testing.assert_array_equal(wl_t.numpy(), np.asarray(wl_j))
    assert np.all(np.isfinite(out))
    err = np.abs(out - ref)
    assert np.sqrt(np.mean(err**2) / np.mean(ref**2)) <= 0.05
    assert err.max() <= 0.1 * np.abs(ref).max()


def test_synthesize_and_predict_lengths_match_jax(params, vocoder):
    """Host bucket choice and stage-1 lengths against the jitted JAX
    `synthesize` / `predict_lengths` on the XLA path: the same bucket, the
    same wav_lengths, samples within 1e-4."""
    vp, voc = vocoder
    cfg, model = _model(params, "xla")
    text, lengths = _text(96)
    jcfg = _jcfg(cfg)
    wav_j, wl_j = jpipe.synthesize(params, vp, text, lengths, jcfg, J_VOC, bucket_multiple=128, mrf_impl="xla")
    wav_t, wl_t = pipeline.synthesize(model, voc, text, lengths, bucket_multiple=128, device="cpu")
    assert wav_t.shape == wav_j.shape and wav_t.shape[1] % (128 * VOC_CFG.hop_size) == 0
    np.testing.assert_array_equal(wl_t, wl_j)
    assert np.abs(wav_t - wav_j).max() <= 1e-4
    np.testing.assert_array_equal(pipeline.predict_lengths(model, text, lengths, device="cpu").numpy(),
                                  np.asarray(jpipe.predict_lengths(params, text, lengths, jcfg)))


@pytest.mark.parametrize("mrf_impl", ["kernel", "plain"])
def test_synthesize_passes_mrf_impl_to_the_vocoder(params, vocoder, monkeypatch, mrf_impl):
    """`synthesize` hands `mrf_impl` to the generator, as `synthesize_fixed`
    does, for either acoustic model."""
    _, voc = vocoder
    seen = []
    forward = voc.forward

    def spy(mel, compute_dtype=None, mrf_impl="kernel"):
        seen.append(mrf_impl)
        return forward(mel, compute_dtype, mrf_impl)

    monkeypatch.setattr(voc, "forward", spy)
    _, model = _model(params, "xla")
    cnn_cfg = EftsCNNConfig(num_symbols=40, symbol_embedding_dim=16, n_channels=16, n_text_encoder_layer=1,
                            n_decoder_layer=1, dropout_rate=0.0)
    cnn = compat.efts_cnn_from_jax(init.init_efts(0, cnn_cfg), cnn_cfg, device="cpu")
    text, lengths = _text(96)
    for m in (model, cnn):
        pipeline.synthesize(m, voc, text, lengths, mrf_impl=mrf_impl, device="cpu")
    assert seen == [mrf_impl, mrf_impl]


def test_registry_and_bridge(params):
    """Each config maps to its model class; the bridge carries pe_scale and
    ignores the training-only subtrees; a model of another family is refused
    by the pipeline."""
    assert set(MODEL_REGISTRY) == {"EfficientTTSCNN", "EfficientTTSTransformer"}
    assert model_class_for(CFG) is EftsTransformer and model_class_for(EftsCNNConfig()) is EftsCNN
    with pytest.raises(TypeError):
        model_class_for(VOC_CFG)
    _, model = _model(params, "xla")
    assert float(model.pe_scale) == pytest.approx(0.7)
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert names == {"text_embedding", "pe_scale", "text_encoder", "text_value", "decoder", "mel_out",
                     "duration_predictor"}
    model.cfg = EftsCNNConfig()
    with pytest.raises(TypeError, match="does not serve"):
        pipeline.predict_lengths(model, *_text(96), device="cpu")


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("cfg", [CFG, dataclasses.replace(CFG, use_conv_ff=False),
                                 EftsTransformerConfig(num_symbols=76)], ids=["small", "linear_ff", "full"])
def test_init_matches_jax_tree(cfg):
    """The port's numpy init has the JAX init's keys and shapes, so the two
    trees are interchangeable (full widths through `jax.eval_shape`, which
    computes nothing)."""
    ref = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), _jcfg(cfg)))
    assert _shapes(init.init_efts_transformer(0, cfg)) == jax.tree_util.tree_map(lambda s: s.shape, ref)


def test_bridge_takes_a_jax_initialised_tree():
    """A tree from the JAX package's own init loads and gives the JAX mel."""
    cfg = dataclasses.replace(CFG, n_text_encoder_layer=1, n_decoder_layer=1)
    p = jax.tree_util.tree_map(np.asarray, jt.init(jax.random.PRNGKey(1), _jcfg(cfg)))
    model = compat.efts_transformer_from_jax(p, cfg, device="cpu")
    text, lengths = _text(96)
    e_j, v_j, tm_j = jt.infer_durations(p, _jcfg(cfg), jnp.asarray(text), jnp.asarray(lengths))
    mel_j, _ = jt.infer_decode(p, _jcfg(cfg), v_j, e_j, tm_j, 128)
    with torch.no_grad():
        e_t, v_t, tm_t = model.infer_durations(torch.from_numpy(text).long(), torch.from_numpy(lengths).long())
        mel_t, _ = model.infer_decode(v_t, e_t, tm_t, 128)
    _close(e_t, e_j, rtol=1e-5, atol=1e-4)
    _close(mel_t, mel_j)


def test_roofline_bounds_of_the_flash_forward():
    """The decoder call's work as the kernel's note states it: 6.44 GFLOP
    and 50.3 MB, bound by bytes at 15.0 us; the V1 stage at C=256 at
    1.094 ms, by operations, as `chip_smoke.py` has always reported it."""
    from efficient_tts_tpu_torch.utils import roofline

    ops, nbytes = roofline.flash_work(16, 4, 512, 512, 96, segmented=False)
    assert (ops, nbytes) == (6442450944.0, 50331648)
    ms, by = roofline.bound_ms(ops, nbytes, "tf32")
    assert by == "bytes" and ms == pytest.approx(0.015024, rel=1e-4)
    ms, by = roofline.bound_ms(*roofline.mrf_stage_work(16, 4096, 256, roofline.v1_taps(), 2, 2), "bf16")
    assert by == "operations" and ms == pytest.approx(1.0944, rel=1e-4)
    assert {r["kernel"].split()[0] for r in roofline.table()} == {"K1", "K2", "K3", "K4", "K5"}
