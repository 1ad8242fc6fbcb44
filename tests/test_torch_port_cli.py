"""The port's CLIs and what they load, on the CPU: `bin/inference.py` against
the JAX package's `pipeline.synthesize` on the same weights (the written
wavs' PCM within one step), the reference vocoder files of
`compat.torch_import.hifigan_generator_from_state_dict` against the weight bridge,
`bin/serve.build_engine`, and `utils/config.py` against the JAX package's
config readers. Sizes as in `tests/test_serve.py`."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu.compat.torch_export import hifigan_generator_to_state_dict
from efficient_tts_tpu.models.efficient_tts import EftsCNNConfig as JEftsCNNConfig
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.nn.layers import fold_weight_norm
from efficient_tts_tpu.text import text_to_sequence as jtext_to_sequence
from efficient_tts_tpu.utils import config as jconfig
from efficient_tts_tpu.utils.masks import pad_list as jpad_list
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.bin import inference, serve as serve_cli
from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.serve import TTSEngine
from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint
from efficient_tts_tpu_torch.utils import config

EFTS_CFG = EftsCNNConfig(num_symbols=148, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=1,
                         n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))
ITEMS = [("wavs/a.wav", "Hello there."), ("wavs/b.wav", "A much longer sentence to synthesize, really."),
         ("wavs/c.wav", "Hi.")]


def _plain(obj):
    """A config dataclass as YAML- and JSON-safe nested lists and dicts."""
    return json.loads(json.dumps(dataclasses.asdict(obj)))


def _write_reference_vocoder(directory, params, folded=False, key="generator"):
    """The JAX package's export of `params` to the reference generator
    layout, saved with torch.save, with a config.yml of the vocoder widths."""
    os.makedirs(directory, exist_ok=True)
    tree = fold_weight_norm(params) if folded else params
    sd = hifigan_generator_to_state_dict(tree, JHiFiGANConfig(**dataclasses.asdict(VOC_CFG)))
    path = os.path.join(directory, "generator.pt")
    torch.save({key: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    with open(os.path.join(directory, "config.yml"), "w") as f:
        yaml.safe_dump({"vocoder_params": _plain(VOC_CFG)}, f)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A port checkpoint of EFTS-CNN with its config.yml, a reference vocoder
    file with its own, a filelist and the seeded trees behind them."""
    root = tmp_path_factory.mktemp("exp")
    ep = init.init_efts(0, EFTS_CFG)
    ep["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
    vp = init.init_generator(1, VOC_CFG)
    model = compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu")
    ckpt = save_checkpoint(str(root / "efts"), {"params": model, "opt_state": None, "step": 7})
    with open(root / "efts" / "config.yml", "w") as f:
        yaml.safe_dump({"model_name": "EfficientTTSCNN", "model_params": _plain(EFTS_CFG)}, f, sort_keys=False)
    voc = _write_reference_vocoder(str(root / "vocoder"), vp)
    scp = root / "test.txt"
    scp.write_text("".join(f"{p}|{t}\n" for p, t in ITEMS) + "\n")
    return {"root": root, "ckpt": ckpt, "voc": voc, "scp": str(scp), "ep": ep, "vp": vp}


def test_inference_cli_matches_jax_synthesize(experiment, tmp_path):
    out = tmp_path / "out"
    timing = tmp_path / "timing.json"
    inference.main(["--test_fid_scp", experiment["scp"], "--checkpoint", experiment["ckpt"], "--outdir", str(out),
                    "--vocoder_checkpoint", experiment["voc"], "--batch_size", "2", "--use_cpu", "--repeats", "2",
                    "--timing_json", str(timing)])
    t = json.loads(timing.read_text())
    assert len(t["passes"]) == 2 and len(t["batches"]) == 4 and set(t["phases"]) == {"efts_load_s", "vocoder_load_s"}
    jcfg, vcfg = JEftsCNNConfig(**dataclasses.asdict(EFTS_CFG)), JHiFiGANConfig(**dataclasses.asdict(VOC_CFG))
    ep, vp = fold_weight_norm(experiment["ep"]), fold_weight_norm(experiment["vp"])
    for lo in range(0, len(ITEMS), 2):
        chunk = ITEMS[lo: lo + 2]
        seqs = [np.asarray(jtext_to_sequence(text), np.int32) for _, text in chunk]
        wav, wl = jpipe.synthesize(ep, vp, jpad_list(seqs), np.asarray([len(s) for s in seqs], np.int32), jcfg, vcfg)
        wav, wl = np.asarray(wav), np.asarray(wl)
        for i, (path, _) in enumerate(chunk):
            name = os.path.splitext(os.path.basename(path))[0]
            sr, pcm = wavfile.read(out / f"{name}_gen.wav")
            want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
            assert sr == VOC_CFG.sampling_rate and pcm.dtype == np.int16 and pcm.shape == want.shape
            assert np.abs(pcm.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("folded, key", [(False, "generator"), (True, "generator"), (False, "model")])
def test_load_vocoder_reads_reference_generator_files(experiment, tmp_path, folded, key):
    path = _write_reference_vocoder(str(tmp_path / "voc"), experiment["vp"], folded=folded, key=key)
    voc = inference.load_vocoder(path, "cpu")
    assert voc.cfg == VOC_CFG
    ref = compat.hifigan_generator_from_jax(experiment["vp"], VOC_CFG, device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, VOC_CFG.num_mels)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(voc(mel).numpy(), ref(mel).numpy(), rtol=0, atol=1e-6)


def test_load_vocoder_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax checkpoint directory of the JAX vocoder trainer"):
        inference._load_vocoder(str(tmp_path), VOC_CFG, "cpu")
    with pytest.raises(ValueError, match="unsupported"):
        inference._load_vocoder(str(tmp_path / "missing"), VOC_CFG, "cpu")


def test_serve_build_engine_random_init_on_cpu():
    engine = serve_cli.build_engine(serve_cli.get_parser().parse_args(["--random_init", "--use_cpu"]))
    assert isinstance(engine, TTSEngine) and engine.device.type == "cpu"
    assert engine.efts_cfg == EftsCNNConfig(num_symbols=148, dropout_rate=0.0, use_masking=True)
    assert engine.voc_cfg == HiFiGANConfig() and engine.max_batch == 16 and engine.compute_dtype is None
    engine = serve_cli.build_engine(serve_cli.get_parser().parse_args(["--random_init", "--use_cpu", "--bf16",
                                                                       "--max_batch", "4"]))
    assert engine.compute_dtype == torch.bfloat16 and engine.max_batch == 4


def test_serve_build_engine_from_checkpoint(experiment):
    args = serve_cli.get_parser().parse_args(["--checkpoint", experiment["ckpt"], "--vocoder_checkpoint",
                                              experiment["voc"], "--use_cpu", "--max_batch", "2"])
    engine = serve_cli.build_engine(args)
    assert engine.efts_cfg == EFTS_CFG and engine.voc_cfg == VOC_CFG
    ref = compat.efts_cnn_from_jax(experiment["ep"], EFTS_CFG, device="cpu")
    for (name, a), (_, b) in zip(engine.model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), name
    (wav,) = engine.synthesize(["Hello there."])
    assert wav.dtype == np.float32 and len(wav) > 0


def test_config_readers_match_jax(tmp_path):
    cnn = {"model_name": "EfficientTTSCNN",
           "model_params": {"n_channels": 64, "use_weighted_masking": True, "nonlinear_activation": "LeakyReLU",
                            "nonlinear_activation_params": {"negative_slope": 0.2}}}
    tr = {"model_name": "EfficientTTSTransformer", "model_params": {"n_channels": 96, "attn_impl": "flash",
                                                                    "use_weighted_masking": False}}
    for d, cls in ((cnn, EftsCNNConfig), (tr, EftsTransformerConfig)):
        got = config.model_config_from_dict(d)
        assert isinstance(got, cls) and dataclasses.asdict(got) == dataclasses.asdict(jconfig.model_config_from_dict(d))
    dur = {"model_name": "DurationModel", "model_params": {"idim": 128, "duration_predictor_chans": 128,
                                                            "num_spks": 4, "spk_embed_dim": 16,
                                                            "spk_embed_integration_type": "concat"}}
    for d in ({"model_name": "DurationModel"}, dur):
        got = config.model_config_from_dict(d)
        assert isinstance(got, DurationModelConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.model_config_from_dict(d))
    with pytest.raises(ValueError, match="unknown model_name"):
        config.model_config_from_dict({"model_name": "Nope"})
    voc = {"vocoder_params": {"upsample_rates": [8, 8, 4], "resblock_dilation_sizes": [[1, 2], [2, 6]]}}
    assert dataclasses.asdict(config.vocoder_config_from_dict(voc)) == dataclasses.asdict(
        jconfig.vocoder_config_from_dict(voc))
    assert config.vocoder_config_near_checkpoint(None) == HiFiGANConfig()
    assert config.vocoder_config_near_checkpoint(str(tmp_path / "nothing_here.pt")) == HiFiGANConfig()
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cnn))
    assert config.load_config(str(path)) == jconfig.load_config(str(path))


def test_load_config_reads_json_without_pyyaml(tmp_path, monkeypatch):
    """A config written as JSON (also YAML) loads where PyYAML is missing;
    YAML text then raises, naming PyYAML."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    as_json, as_yaml = tmp_path / "a.yml", tmp_path / "b.yml"
    as_json.write_text(json.dumps({"model_name": "EfficientTTSCNN", "model_params": {"n_channels": 8}}))
    as_yaml.write_text("model_name: EfficientTTSCNN\n")
    assert config.model_config_from_dict(config.load_config(str(as_json))).n_channels == 8
    with pytest.raises(ImportError, match="PyYAML"):
        config.load_config(str(as_yaml))
