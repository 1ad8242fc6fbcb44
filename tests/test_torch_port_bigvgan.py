"""BigVGAN in the port, on the CPU at tiny widths: the generator and its
anti-aliased activation against the benchmark's plain reference
(`port_bench/reference/bigvgan.py`) on seeded random weights in the published
state-dict layout, the filter's taps, the resamplers' lengths, weight-norm
folding, planted faults, the synthesis path (`pipeline`, `TTSEngine`,
`bin/inference.py`), the vocoders that refuse it, the config readers and the
benchmark cell at a narrowed size."""

import copy
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from efficient_tts_tpu_torch import compat, pipeline
from efficient_tts_tpu_torch.bin import inference
from efficient_tts_tpu_torch.models import bigvgan as bigvgan_model
from efficient_tts_tpu_torch.models.bigvgan import BigVGANConfig, BigVGANGenerator
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, generator_chunked
from efficient_tts_tpu_torch.ops import alias_free
from efficient_tts_tpu_torch.serve import TTSEngine
from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint
from efficient_tts_tpu_torch.utils import config
from port_bench import program, run, spec, weights, weights_bigvgan
from port_bench.reference import bigvgan as ref
from port_bench.reference import efts as ref_efts
from port_bench.reference.ops import Ops
from port_bench.reference.text import encode
from port_bench.tests.tiny import TINY_MODEL

CELL = "bigvgan_synth_b16"
TINY = {"upsample_initial_channel": 32, "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
        "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 3]], "hop_size": 8}
TEXTS = ["Of the witness.", "A.", "The prisoner said that money was in the house."]
TOL = 1e-5  # of the reference's peak: f32 on both sides, the same ops in another grouping


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg_dict() -> dict:
    """The cell's configuration at the tiny widths."""
    cfg = copy.deepcopy(spec.load_cell(CELL).config)
    cfg["model_params"].update(TINY_MODEL["EfficientTTSCNN"])
    cfg["vocoder_params"].update(TINY)
    return cfg


def _voc_cfg(v: dict) -> BigVGANConfig:
    return config.vocoder_config_from_dict({"vocoder_name": "BigVGAN", "vocoder_params": v})


def _vocoder(seed=3, folded=False):
    """(vocoder_params, published state dict, the port's generator)."""
    v = _cfg_dict()["vocoder_params"]
    sd = weights_bigvgan.make_state_dict(v, seed, "cpu")
    if folded:
        sd = _folded(sd)
    return v, sd, compat.bigvgan_generator_from_state_dict(sd, _voc_cfg(v), device="cpu")


def _folded(sd: dict) -> dict:
    """The state dict with every weight-normed layer folded as torch folds it (f32)."""
    out = {}
    for k, t in sd.items():
        if k.endswith(".weight_v"):
            base = k[:-len(".weight_v")]
            out[base + ".weight"] = torch._weight_norm(t, sd[base + ".weight_g"], 0)
        elif not k.endswith(".weight_g"):
            out[k] = t
    return out


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _mel(t=21, b=2, seed=0):
    return torch.randn(b, t, 80, generator=torch.Generator().manual_seed(seed)) * 2 - 4


def test_kaiser_sinc_taps():
    half = [0.002029, 0.009389, -0.025543, -0.057657, 0.128573, 0.443210]
    h = alias_free.kaiser_sinc_filter().double().numpy()
    np.testing.assert_allclose(h, half + half[::-1], atol=1e-6)
    np.testing.assert_allclose(h, ref.kaiser_sinc_filter1d().reshape(-1).double().numpy(), atol=1e-7)
    assert abs(h.sum() - 1) < 1e-6


@pytest.mark.parametrize("t", [1, 2, 7, 64])
def test_resampler_lengths(t):
    x = torch.randn(2, 3, t)
    h = alias_free.kaiser_sinc_filter()
    up = alias_free.upsample2(x, h)
    assert up.shape == (2, 3, 2 * t)
    assert alias_free.downsample2(up, h).shape == (2, 3, t)


def test_activation_matches_reference():
    v, sd, voc = _vocoder()
    x = torch.randn(2, 8, 37)
    act = voc.resblocks[2].activations[3]  # the second stage: 8 channels
    got = act(x)
    want = ref.activation(x, sd, "resblocks.2.activations.3", True, Ops())
    assert _rel(got, want) <= TOL
    assert _rel(got, x) > 1e-2  # it does something


@pytest.mark.parametrize("folded", [False, True], ids=["weight_normed", "folded"])
def test_generator_matches_reference(folded):
    v, sd, voc = _vocoder(folded=folded)
    mel = _mel()
    with torch.no_grad():
        got, want = voc(mel), ref.generator(sd, v, mel, Ops())
    assert got.shape == (2, 21 * 8) and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    # the weight-normed and the folded file give one generator, to rounding
    _, _, other = _vocoder(folded=not folded)
    assert _rel(other(mel), got) <= TOL


def test_weight_norm_folds_over_the_first_axis():
    """A transposed conv's g is per input channel ([in, out, k] weights), a
    conv's per output channel: the loader folds g * v / ||v|| over every axis
    but the first, as torch's weight_norm(dim=0) does."""
    v, sd, _ = _vocoder()
    sd = dict(sd)
    gen = torch.Generator().manual_seed(9)
    for key in ("ups.0.0", "resblocks.1.convs1.0"):
        sd[key + ".weight_g"] = torch.rand(sd[key + ".weight_g"].shape, generator=gen) + 0.5
    voc = compat.bigvgan_generator_from_state_dict(sd, _voc_cfg(v), device="cpu")
    for key, layer in (("ups.0.0", voc.ups[0][0]), ("resblocks.1.convs1.0", voc.resblocks[1].convs1[0])):
        wv, wg = sd[key + ".weight_v"], sd[key + ".weight_g"]
        want = wg.double() * wv.double() / wv.double().square().sum(dim=(1, 2), keepdim=True).sqrt()
        torch.testing.assert_close(layer.weight.double(), want, rtol=1e-6, atol=1e-9)
        assert _rel(layer.weight, torch._weight_norm(wv, wg, 0)) < 1e-6
    # the ups' input channels (its weight's first axis) are not its output channels: the wrong axis would show
    assert sd["ups.0.0.weight_v"].shape[0] != sd["ups.0.0.weight_v"].shape[1]
    with torch.no_grad():
        mel = _mel()
        assert _rel(voc(mel), ref.generator(sd, v, mel, Ops())) <= TOL


def test_loader_refuses_another_filter():
    v, sd, _ = _vocoder()
    sd = dict(sd)
    sd["resblocks.0.activations.1.downsample.lowpass.filter"] = sd["resblocks.0.activations.1.upsample.filter"] * 1.01
    with pytest.raises(ValueError, match="Kaiser"):
        compat.bigvgan_generator_from_state_dict(sd, _voc_cfg(v), device="cpu")


def _zero_pad_upsample2(x, h):
    c = x.shape[1]
    w = (2.0 * h).view(1, 1, 12).expand(c, 1, 12)
    return F.conv_transpose1d(F.pad(x, (5, 5)), w, stride=2, groups=c)[..., 15:-15]


def _zero_pad_downsample2(x, h):
    c = x.shape[1]
    return F.conv1d(F.pad(x, (5, 6)), h.view(1, 1, 12).expand(c, 1, 12), stride=2, groups=c)


@pytest.mark.parametrize("fault", ["alpha_beta_swapped", "zero_padding", "no_activation_before_conv_post"])
def test_planted_fault_fails_the_comparison(fault, monkeypatch):
    v, sd, voc = _vocoder()
    if fault == "alpha_beta_swapped":
        real = bigvgan_model.snake_coefficients
        monkeypatch.setattr(bigvgan_model, "snake_coefficients", lambda a, b, log: real(b, a, log))
    elif fault == "zero_padding":
        monkeypatch.setattr(alias_free, "upsample2", _zero_pad_upsample2)
        monkeypatch.setattr(alias_free, "downsample2", _zero_pad_downsample2)
    else:
        monkeypatch.setattr(voc.activation_post, "forward", lambda x: x)
    mel = _mel()
    with torch.no_grad():
        assert _rel(voc(mel), ref.generator(sd, v, mel, Ops())) > 10 * TOL


def _tiny_system(seed=11):
    """(config dict, acoustic tree, vocoder state dict, EFTS-CNN, BigVGAN) on the CPU."""
    cfg = _cfg_dict()
    mp = cfg["model_params"]
    pin = np.log(cfg["pinned_frames_per_symbol"] + mp["duration_offset"])
    tree = weights.make_tree(weights.efts_cnn_spec(mp, training=False, pin=pin), seed, "cpu")
    sd = weights_bigvgan.make_state_dict(cfg["vocoder_params"], seed + 1, "cpu")
    model = compat.efts_cnn_from_jax(weights.to_numpy(tree), program.model_config(cfg), device="cpu")
    voc = compat.bigvgan_generator_from_state_dict(sd, program.vocoder_config(cfg), device="cpu")
    return cfg, tree, sd, model, voc


def _text():
    ids = [encode(t) for t in TEXTS]
    lengths = np.array([len(i) for i in ids])
    text = np.zeros((len(ids), lengths.max()), np.int64)
    for j, i in enumerate(ids):
        text[j, :len(i)] = i
    return text, lengths


def test_synthesis_path_matches_reference():
    """`synthesize` (dispatch + fetch) and `synthesize_fixed` run the generator
    as they run HiFi-GAN's, and agree with the plain reference."""
    cfg, tree, sd, model, voc = _tiny_system()
    assert isinstance(voc, BigVGANGenerator)
    text, lengths = _text()
    wav, wav_lengths = pipeline.synthesize(model, voc, text, lengths, bucket_multiple=64, device="cpu")
    mp, vp, hop = cfg["model_params"], cfg["vocoder_params"], cfg["vocoder_params"]["hop_size"]
    with torch.no_grad():
        s1 = ref_efts.cnn_stage1(tree, mp, torch.from_numpy(text), torch.from_numpy(lengths), Ops())
        t2 = ref_efts.bucket(int(s1["lengths"].max()), 64)
        ref_mel, ref_lengths = ref_efts.cnn_decode(tree, mp, s1, [0, 1, 2], t2, Ops())
        ref_wav = ref.generator(sd, vp, ref_mel, Ops())
    assert np.array_equal(np.asarray(wav_lengths), ref_lengths.numpy() * hop)
    fixed, fixed_lengths, _ = pipeline.synthesize_fixed(model, voc, text, lengths, t2, device="cpu")
    for j in range(3):
        n = int(ref_lengths[j]) * hop
        assert _rel(torch.as_tensor(np.asarray(wav[j, :n])), ref_wav[j, :n]) <= TOL
        assert np.array_equal(np.asarray(fixed[j, :n]), np.asarray(wav[j, :n]))


def test_engine_serves_bigvgan_as_synthesize_does():
    _, _, _, model, voc = _tiny_system()
    # t1_multiple 1: text padded as `synthesize` pads it (padding it further moves EFTS-CNN's last frames)
    engine = TTSEngine(model, voc, device="cpu", max_batch=4, t1_multiple=1, pcm16_transfer=False)
    got = engine.synthesize(TEXTS)
    text, lengths = _text()
    want, want_lengths = pipeline.synthesize(model, voc, text, lengths, bucket_multiple=engine.t2_multiple,
                                             device="cpu")
    for j, w in enumerate(got):
        assert len(w) == int(want_lengths[j])
        np.testing.assert_allclose(w, np.asarray(want[j, :len(w)]), rtol=0, atol=TOL * np.abs(w).max())


def test_inference_cli_reads_a_published_bigvgan_file(tmp_path):
    """`--vocoder_checkpoint` on `{"generator": state_dict}` with NVIDIA/BigVGAN's
    flat config.json beside it; the written PCM is `synthesize`'s."""
    cfg, _, sd, model, voc = _tiny_system()
    ckpt = save_checkpoint(str(tmp_path / "efts"), {"params": model, "opt_state": None, "step": 3})
    with open(tmp_path / "efts" / "config.yml", "w") as f:
        json.dump({"model_name": "EfficientTTSCNN", "model_params": cfg["model_params"]}, f)
    (tmp_path / "bigvgan").mkdir()
    torch.save({"generator": sd}, tmp_path / "bigvgan" / "bigvgan_generator.pt")
    published = {**cfg["vocoder_params"], "num_gpus": 0, "batch_size": 32, "segment_size": 65536, "fmax": 8000}
    (tmp_path / "bigvgan" / "config.json").write_text(json.dumps(published))
    scp = tmp_path / "test.txt"
    scp.write_text("".join(f"wavs/u{j}.wav|{t}\n" for j, t in enumerate(TEXTS)))
    out = tmp_path / "out"
    inference.main(["--test_fid_scp", str(scp), "--checkpoint", ckpt, "--outdir", str(out), "--vocoder_checkpoint",
                    str(tmp_path / "bigvgan" / "bigvgan_generator.pt"), "--batch_size", "3", "--use_cpu"])
    text, lengths = _text()
    wav, wav_lengths = pipeline.synthesize(model, voc, text, lengths, device="cpu")
    for j in range(3):
        sr, pcm = wavfile.read(out / f"u{j}_gen.wav")
        want = (np.clip(np.asarray(wav[j, :int(wav_lengths[j])]), -1, 1) * 32767).astype(np.int16)
        assert sr == 22050 and np.abs(pcm.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("vocode", ["generator_chunked", "stream_vocoder", "sequence_parallel"])
def test_vocoders_sized_for_v1_refuse_bigvgan(vocode):
    _, _, voc = _vocoder()
    mel = _mel(t=400, b=1)
    with pytest.raises(TypeError, match="sizes its overlap for HiFi-GAN V1"):
        if vocode == "generator_chunked":
            generator_chunked(voc, mel, device="cpu")
        elif vocode == "stream_vocoder":
            pipeline.stream_vocoder(voc, mel[0].numpy(), device="cpu")
        else:
            pipeline._vocode_frames(voc, mel, mesh=None, cdt=None)


def test_vocoder_config_by_name(tmp_path):
    tiny = _voc_cfg(_cfg_dict()["vocoder_params"])
    assert isinstance(tiny, BigVGANConfig) and tiny.total_upsampling == tiny.hop_size == 8
    assert tiny.resblock_dilation_sizes == ((1, 3), (1, 3)) and tiny.upsample_initial_channel == 32
    assert config.vocoder_config_from_dict({}) == HiFiGANConfig()
    with pytest.raises(ValueError, match="unknown vocoder_name"):
        config.vocoder_config_from_dict({"vocoder_name": "WaveNet"})
    assert config.vocoder_config_near_checkpoint(str(tmp_path / "g.pt")) == HiFiGANConfig()
    (tmp_path / "config.json").write_text(json.dumps({**dataclasses.asdict(BigVGANConfig()), "learning_rate": 1e-4}))
    assert config.vocoder_config_near_checkpoint(str(tmp_path / "g.pt")) == BigVGANConfig()
    os.remove(tmp_path / "config.json")
    (tmp_path / "config.json").write_text(json.dumps({"resblock": "2", "upsample_initial_channel": 128, "n_fft": 1024}))
    assert config.vocoder_config_near_checkpoint(str(tmp_path / "g.pt")) == HiFiGANConfig(
        resblock="2", upsample_initial_channel=128)


def _tiny_cell(seed=5):
    cell = copy.deepcopy(spec.load_cell(CELL))
    cell.config = _cfg_dict()
    cell.traffic.update(batch=3, batches=2, check_rows=3)
    cell.seed, cell.device = seed, "cpu"
    return cell


def test_benchmark_cell_sound_run_is_correct_and_the_control_is_not():
    cell = _tiny_cell()
    result = run.execute(cell, 0.3, False, time.perf_counter())
    assert result["correct"], result["check"]
    assert result["metrics"]["synth_audio_s_per_s"]["value"] > 0 and result["attempted"] > 0
    session = spec.driver(cell).Session(cell)
    session.window(0.2)
    session.release()
    session.substitute(Ops(tf32=True))
    numbers = session.check(Ops())
    assert any(v > cell.limits["limits"][k] for k, v in numbers.items()), numbers
