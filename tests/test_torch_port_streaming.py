"""The rest of the port's synthesis path against the JAX package, on the CPU:
`decode_mel_fixed`, `generator_chunked`, `stream_vocoder`, the ResBlock2
generator (HiFi-GAN V2/V3 family) and `synthesize_dispatch` + `fetch`.

The same seeded numpy trees (`efficient_tts_tpu_torch/init.py`, or the JAX
package's own init where the tree's keys are the point) feed the JAX
functions and, through the weight bridge, the port. The JAX generator runs
its packed small-channel layouts (`mrf_impl="xla"`), exact re-layouts of the
port's plain math, so f32 waveforms agree to atol 1e-5 (sums in another
order); mels as in `tests/test_torch_port_pipeline.py` (rtol = atol =
1e-4). The EFTS-Transformer's JAX flash kernel runs only on a TPU: for
"flash" the JAX side runs its library's plain reference with the same
segment ids, patched in for the test only, and unjitted (`jax.disable_jit`),
so no jit cache keeps the patched trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

import efficient_tts_tpu.nn.attention as jattn
from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu.models import efficient_tts as jefts
from efficient_tts_tpu.models import efficient_tts_transformer as jt
from efficient_tts_tpu.models import hifigan as hg
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, ResBlock2Stage, generator_chunked

WAV_ATOL = 1e-5
MEL_TOL = dict(rtol=1e-4, atol=1e-4)
EFTS_CFG = EftsCNNConfig(num_symbols=40, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=2,
                         n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0, use_masking=True)
TR_CFG = EftsTransformerConfig(num_symbols=40, n_channels=64, n_heads=2, ff_hidden=128, n_text_encoder_layer=2,
                               n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32)
# tests/test_hifigan_chunked.py's generator
CHUNK_CFG = HiFiGANConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
                          resblock_dilation_sizes=((1, 3), (1, 3)))
# HiFi-GAN's published config_v3.json (tests/test_hifigan.py's ResBlock2 case)
V3_CFG = HiFiGANConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                       upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
                       resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def _jcfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def _voc(cfg, seed=1):
    vp = init.init_generator(seed, cfg)
    return vp, compat.hifigan_generator_from_jax(vp, cfg, device="cpu")


@pytest.fixture(scope="module")
def cnn():
    ep = init.init_efts(0, EFTS_CFG)
    ep["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
    return ep, compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu")


@pytest.fixture(scope="module")
def vocoder():
    return _voc(VOC_CFG)


def _text(t1, lengths, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    text = np.zeros((len(lengths), t1), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, 40, n)
    return text, lengths


def _patched_flash(q, k, v, mask, dk):
    seg = None
    if mask is not None:
        ids = mask[:, 0, :].astype(jnp.int32)
        seg = JSegmentIds(q=ids, kv=ids)
    return mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=1.0 / float(np.sqrt(dk)))


# ---------------------------------------------------------------------------
# decode_mel_fixed


@pytest.mark.parametrize("duration_correction", [False, True])
def test_decode_mel_fixed_cnn(cnn, duration_correction):
    ep, em = cnn
    text, lengths = _text(14, [14, 9, 5])
    mel_j, ml_j = jpipe.decode_mel_fixed(ep, jnp.asarray(text), jnp.asarray(lengths), _jcfg(jefts.EftsCNNConfig,
                                                                                           EFTS_CFG), 64,
                                         duration_correction=duration_correction)
    mel_t, ml_t = pipeline.decode_mel_fixed(em, text, lengths, 64, duration_correction=duration_correction,
                                            device="cpu")
    assert ml_t.dtype == torch.int32 and mel_t.shape == (3, 64, EFTS_CFG.odim)
    np.testing.assert_array_equal(ml_t.numpy(), np.asarray(ml_j))
    assert int(ml_t.min()) < 64  # a tail is masked
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), **MEL_TOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_decode_mel_fixed_transformer(monkeypatch, impl):
    """At T1 = 128, t2 = 256 (every attention call eligible for flash)."""
    monkeypatch.setattr(jattn, "_flash_attention", _patched_flash)
    cfg = dataclasses.replace(TR_CFG, attn_impl=impl)
    p = init.init_efts_transformer(0, cfg)
    p["duration_predictor"]["out"]["b"] = np.full((1,), 0.5, np.float32)
    model = compat.efts_transformer_from_jax(p, cfg, device="cpu")
    text, lengths = _text(128, [128, 100, 64])
    with jax.disable_jit():
        mel_j, ml_j = jpipe.decode_mel_fixed(p, jnp.asarray(text), jnp.asarray(lengths),
                                             _jcfg(jt.EftsTransformerConfig, cfg), 256)
    mel_t, ml_t = pipeline.decode_mel_fixed(model, text, lengths, 256, device="cpu")
    np.testing.assert_array_equal(ml_t.numpy(), np.asarray(ml_j))
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), **MEL_TOL)


def test_decode_mel_fixed_is_the_mel_of_synthesize_fixed(cnn, vocoder):
    """Bit-equal to the mel `synthesize_fixed` returns, in f32 and bf16."""
    _, em = cnn
    _, vm = vocoder
    text, lengths = _text(14, [14, 9, 5])
    for cdt in (None, torch.bfloat16):
        mel, ml = pipeline.decode_mel_fixed(em, text, lengths, 64, compute_dtype=cdt, device="cpu")
        _, wl, mel_s = pipeline.synthesize_fixed(em, vm, text, lengths, 64, compute_dtype=cdt, device="cpu")
        assert torch.equal(mel, mel_s) and torch.equal(ml * VOC_CFG.hop_size, wl)


# ---------------------------------------------------------------------------
# generator_chunked


@pytest.mark.parametrize("t,chunk", [(70, 32), (300, 128)])
def test_generator_chunked_matches_jax_and_full_pass(t, chunk):
    """tests/test_hifigan_chunked.py's generator and cases; the port's chunked
    pass against JAX's and against the port's own full pass."""
    vp, vm = _voc(CHUNK_CFG, seed=0)
    mel = np.random.default_rng(t).standard_normal((2 if t < 100 else 1, t, 80)).astype(np.float32)
    wav_t = generator_chunked(vm, mel, chunk_frames=chunk, overlap_frames=24, device="cpu")
    wav_j = np.asarray(hg.generator_chunked(vp, mel, _jcfg(hg.HiFiGANConfig, CHUNK_CFG), chunk_frames=chunk,
                                            overlap_frames=24))
    with torch.no_grad():
        full = vm(torch.from_numpy(mel))
    assert wav_t.shape == (mel.shape[0], t * 256)
    np.testing.assert_allclose(wav_t.numpy(), wav_j, rtol=0, atol=WAV_ATOL)
    np.testing.assert_allclose(wav_t.numpy(), full.numpy(), rtol=0, atol=WAV_ATOL)


def test_generator_chunked_passes_dtype_and_impl(monkeypatch):
    _, vm = _voc(CHUNK_CFG, seed=0)
    seen = []
    forward = vm.forward

    def spy(mel, compute_dtype=None, mrf_impl="kernel"):
        seen.append((mel.shape[1], compute_dtype, mrf_impl))
        return forward(mel, compute_dtype, mrf_impl)

    monkeypatch.setattr(vm, "forward", spy)
    mel = np.zeros((1, 100, 80), np.float32)
    generator_chunked(vm, mel, torch.bfloat16, "plain", chunk_frames=32, overlap_frames=8, device="cpu")
    # 4 windows: the first and last of chunk + overlap frames, the middle ones of chunk + 2 overlap,
    # the second cut where it reaches the mel's end (mel[56:104] of 100 frames), as JAX's slice is
    assert seen == [(40, torch.bfloat16, "plain"), (48, torch.bfloat16, "plain"), (44, torch.bfloat16, "plain"),
                    (40, torch.bfloat16, "plain")]


# ---------------------------------------------------------------------------
# stream_vocoder


@pytest.mark.parametrize("t", [40, 200])
def test_stream_vocoder_matches_jax(vocoder, t):
    """t = 40: the short single window, padded to 64 frames; t = 200: four
    chunks of 64 frames. Each chunk against JAX's; the joined chunks of the
    multi-chunk path against the port's full pass."""
    vp, vm = vocoder
    mel = np.random.default_rng(t).standard_normal((t, 80)).astype(np.float32)
    chunks_t = list(pipeline.stream_vocoder(vm, mel, chunk_frames=64, overlap_frames=24, device="cpu"))
    chunks_j = list(jpipe.stream_vocoder(vp, mel, _jcfg(hg.HiFiGANConfig, VOC_CFG), chunk_frames=64,
                                         overlap_frames=24))
    assert [c.shape for c in chunks_t] == [c.shape for c in chunks_j]
    assert len(chunks_t) == (1 if t <= 64 + 48 else -(-t // 64))
    for a, b in zip(chunks_t, chunks_j):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=WAV_ATOL)
    if len(chunks_t) > 1:
        with torch.no_grad():
            full = vm(torch.from_numpy(mel[None]))[0].numpy()
        np.testing.assert_allclose(np.concatenate(chunks_t), full, rtol=0, atol=WAV_ATOL)


def test_stream_vocoder_windows(vocoder, monkeypatch):
    """At most three window shapes for any length; the first window is
    mel[:chunk + ov] and the last ends at t."""
    _, vm = vocoder
    seen = []
    forward = vm.forward

    def spy(mel, compute_dtype=None, mrf_impl="kernel"):
        seen.append(mel[0, :, 0].clone())
        return forward(mel, compute_dtype, mrf_impl)

    monkeypatch.setattr(vm, "forward", spy)
    t = 300
    mel = np.tile(np.arange(t, dtype=np.float32)[:, None], (1, 80))
    list(pipeline.stream_vocoder(vm, mel, chunk_frames=64, overlap_frames=24, device="cpu"))
    assert len({len(s) for s in seen}) <= 3
    assert seen[0].tolist() == list(range(88)) and seen[-1].tolist() == list(range(t - 88, t))


# ---------------------------------------------------------------------------
# ResBlock2 (HiFi-GAN V3 widths)


@pytest.fixture(scope="module")
def v3():
    """The JAX package's own init (weight norm {v, g, b}, `convs` per block)
    through the bridge."""
    jcfg = _jcfg(hg.HiFiGANConfig, V3_CFG)
    vp = jax.tree_util.tree_map(np.asarray, hg.init_generator(jax.random.PRNGKey(0), jcfg))
    return jcfg, vp, compat.hifigan_generator_from_jax(vp, V3_CFG, device="cpu")


def test_resblock2_generator_matches_jax(v3):
    """f32 at atol 1e-5; bf16 within the pipeline tests' bf16 bound (RMS
    error <= 5% of the waveform's RMS, max <= 0.1 of its range)."""
    jcfg, vp, vm = v3
    assert all(isinstance(s, ResBlock2Stage) for s in vm.stages)
    mel = np.random.default_rng(1).standard_normal((2, 17, 80)).astype(np.float32)
    with torch.no_grad():
        out = vm(torch.from_numpy(mel))
        out_bf16 = vm(torch.from_numpy(mel), compute_dtype=torch.bfloat16)
    ref = np.asarray(hg.generator(vp, jnp.asarray(mel), jcfg))
    assert out.shape == (2, 17 * 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=WAV_ATOL)
    ref16 = np.asarray(hg.generator(vp, jnp.asarray(mel), jcfg, compute_dtype=jnp.bfloat16))
    err = np.abs(out_bf16.numpy() - ref16)
    assert np.all(np.isfinite(out_bf16.numpy()))
    assert np.sqrt(np.mean(err**2) / np.mean(ref16**2)) <= 0.05 and err.max() <= 0.1 * np.abs(ref16).max()


def test_resblock2_init_matches_jax_tree():
    key = jax.random.PRNGKey(0)
    jv = jax.eval_shape(lambda: hg.init_generator(key, _jcfg(hg.HiFiGANConfig, V3_CFG)))
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), init.init_generator(1, V3_CFG))
    assert shapes == jax.tree_util.tree_map(lambda s: s.shape, jv)


def test_resblock2_stage_rejects_an_unknown_impl():
    stage = ResBlock2Stage(8, (3,), ((1,),))
    with pytest.raises(ValueError, match="mrf_impl"):
        stage(torch.zeros(1, 4, 8), "pallas")


# ---------------------------------------------------------------------------
# synthesize_dispatch + fetch


def test_dispatch_then_fetch_is_synthesize(cnn, vocoder):
    """Two batches dispatched before either is fetched; each equals
    `synthesize` bit for bit and JAX's dispatch + fetch within 1e-4 (as
    `synthesize` is held in tests/test_torch_port_pipeline.py), with the same
    wav_lengths and the same `timings` keys."""
    ep, em = cnn
    vp, vm = vocoder
    batches = [_text(14, [14, 9, 5]), _text(11, [11, 4], seed=1)]
    timings = [{}, {}]
    handles = [pipeline.synthesize_dispatch(em, vm, *b, bucket_multiple=32, timings=tm, device="cpu")
               for b, tm in zip(batches, timings)]
    for (text, lengths), (handle, wl), tm in zip(batches, handles, timings):
        assert handle.done is None  # a CPU dispatch makes no copy
        wav = pipeline.fetch(handle)
        wav_s, wl_s = pipeline.synthesize(em, vm, text, lengths, bucket_multiple=32, device="cpu")
        np.testing.assert_array_equal(wav, wav_s)
        np.testing.assert_array_equal(wl, wl_s)
        jt_ = {}
        wav_jd, wl_j = jpipe.synthesize_dispatch(ep, vp, text, lengths, _jcfg(jefts.EftsCNNConfig, EFTS_CFG),
                                                 _jcfg(hg.HiFiGANConfig, VOC_CFG), bucket_multiple=32,
                                                 mrf_impl="xla", timings=jt_)
        wav_j = jpipe._to_host(wav_jd)
        assert wav.shape == wav_j.shape and wl.dtype == np.int32
        np.testing.assert_array_equal(wl, wl_j)
        assert np.abs(wav - wav_j).max() <= 1e-4
        assert set(tm) == set(jt_) == {"stage1_s", "dispatch_s", "t2"}
        assert tm["t2"] == jt_["t2"] == wav.shape[1] // VOC_CFG.hop_size
        assert tm["stage1_s"] > 0 and tm["dispatch_s"] > 0


def test_dispatch_pcm16(cnn, vocoder):
    _, em = cnn
    _, vm = vocoder
    text, lengths = _text(14, [14, 9, 5])
    handle, wl = pipeline.synthesize_dispatch(em, vm, text, lengths, output="pcm16", device="cpu")
    wav = pipeline.fetch(handle)
    assert wav.dtype == np.int16
    for i, n in enumerate(wl):
        assert np.all(wav[i, n:] == 0)
