"""The training CLI (`bin/train.py`) on the CPU, and inference from what it wrote.

A seeded synthetic corpus (`bench/corpus.py`: 6 train and 2 dev
utterances of 0.4-1.0 s) and tiny JSON configs (EFTS-CNN: 24 channels,
1/1/1 res-conv layers; EFTS-Transformer: width 16, 2 heads, 1/1/1 blocks;
148 symbols, 80 mels, the char yaml's optimizer with a 4-step warmup):
`--use_cpu` runs of 2 steps with an eval, `config.yml`, checkpoints,
automatic and explicit resumes, dotted `--set` overrides, and
`bin.inference --use_cpu` on the trained EFTS-CNN checkpoint (weight-normed,
with training modules) against `pipeline.synthesize` on the same folded
model, PCM for PCM.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from efficient_tts_tpu.compat.torch_export import hifigan_generator_to_state_dict
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu_torch import init, pipeline
from efficient_tts_tpu_torch.bench.corpus import make_corpus
from efficient_tts_tpu_torch.bin import inference, train
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformer
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.nn.layers import WNConv1d
from efficient_tts_tpu_torch.text import text_to_sequence
from efficient_tts_tpu_torch.utils.config import load_config
from efficient_tts_tpu_torch.utils.masks import pad_list

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_PARAMS = dict(num_symbols=148, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=1,
                  n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
TR_PARAMS = dict(num_symbols=148, n_channels=16, n_heads=2, ff_hidden=32, n_text_encoder_layer=1,
                 n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, attn_impl="auto")
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))


def _config(model_name, model_params, wavs):
    """The char yaml with a tiny model, batch 3 and a 4-step warmup."""
    config = load_config(os.path.join(ROOT, "efficient_tts_tpu_torch", "configs", "lj_efts_cnn_char.yaml"))
    config.update(model_name=model_name, model_params=model_params, batch_size=3, train_max_steps=2,
                  save_interval_steps=2, eval_interval_steps=1, log_interval_steps=1)
    config["dataset_params"]["wav_path"] = wavs
    config["scheduler_params"] = {"warmup_steps": 4}
    return config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    paths = make_corpus(str(root), n_train=6, n_dev=2, seed=1, min_s=0.4, max_s=1.0)
    for name, model_name, params in (("cnn", "EfficientTTSCNN", CNN_PARAMS),
                                     ("transformer", "EfficientTTSTransformer", TR_PARAMS)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(_config(model_name, params, paths["wavs"]), f)
    paths["root"] = root
    return paths


@pytest.fixture(scope="module")
def cnn_run(corpus):
    """2 steps of EFTS-CNN with a dev set, then an automatic resume to 3."""
    outdir = str(corpus["root"] / "exp_cnn")
    first = train.main(["--config", corpus["cnn"], "--train_fid_scp", corpus["train"], "--dev_fid_scp", corpus["dev"],
                        "--outdir", outdir, "--use_cpu", "--set", "model_params.loss_normalize=utterance"])
    second = train.main(["--config", corpus["cnn"], "--train_fid_scp", corpus["train"], "--outdir", outdir,
                         "--use_cpu", "--set", "train_max_steps=3", "--set", "model_params.loss_normalize=utterance"])
    return {"outdir": outdir, "first": first, "second": second}


def test_train_cli_trains_checkpoints_and_resumes_the_cnn(cnn_run, corpus):
    first, second, outdir = cnn_run["first"], cnn_run["second"], cnn_run["outdir"]
    assert isinstance(first.state["params"], EftsCNN)
    assert first.state["step"] == 2 and [t["step"] for t in first.step_times] == [1, 2]
    assert all(t["wall_s"] >= t["data_wait_s"] >= 0 for t in first.step_times)
    assert len(first.eval_batches) == 1 and first.eval_batches[0]["text"].shape[0] == 2  # the dev set < a batch
    assert second.state["step"] == 3 and second.state["opt_state"]["count"] == 3
    assert [t["step"] for t in second.step_times] == [3]
    assert sorted(n for n in os.listdir(outdir) if n.startswith("checkpoint-")) == ["checkpoint-2steps",
                                                                                    "checkpoint-3steps"]
    dumped = load_config(os.path.join(outdir, "config.yml"))
    assert dumped["model_params"]["loss_normalize"] == "utterance" and dumped["train_max_steps"] == 3
    keys = torch.load(os.path.join(outdir, "checkpoint-3steps"), map_location="cpu", weights_only=True)["params"]
    assert "decoder.layers.0.v" in keys and "mel_encoder.layers.0.g" in keys
    # an explicit --resume restores the step and trains on to the new maximum
    third = train.main(["--config", corpus["cnn"], "--train_fid_scp", corpus["train"], "--outdir", outdir,
                        "--use_cpu", "--resume", os.path.join(outdir, "checkpoint-2steps"), "--set",
                        "train_max_steps=4", "--set", "model_params.loss_normalize=utterance"])
    assert third.state["step"] == 4 and [t["step"] for t in third.step_times] == [3, 4]
    means = first.evaluate(first.state["step"])
    assert set(means) == {"loss", "mel_loss", "duration_loss", "align_peak"}
    assert all(np.isfinite(v) for v in means.values())


def _reference_vocoder(directory):
    """A reference HiFi-GAN generator file of the tiny widths (the JAX
    package's export of seeded weights) with its config.yml."""
    os.makedirs(directory, exist_ok=True)
    sd = hifigan_generator_to_state_dict(init.init_generator(1, VOC_CFG), JHiFiGANConfig(**dataclasses.asdict(VOC_CFG)))
    path = os.path.join(directory, "generator.pt")
    torch.save({"generator": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    with open(os.path.join(directory, "config.yml"), "w") as f:
        yaml.safe_dump({"vocoder_params": json.loads(json.dumps(dataclasses.asdict(VOC_CFG)))}, f)
    return path


def test_inference_cli_synthesizes_from_the_trained_cnn(cnn_run, corpus, tmp_path):
    """The trainer's checkpoint (weight norm as {v, g}, training modules) is
    folded for inference; the CLI's wavs equal `pipeline.synthesize` on the
    loaded models, PCM for PCM."""
    ckpt = os.path.join(cnn_run["outdir"], "checkpoint-3steps")
    voc_path = _reference_vocoder(str(tmp_path / "vocoder"))
    out = tmp_path / "wavs"
    inference.main(["--test_fid_scp", corpus["dev"], "--checkpoint", ckpt, "--outdir", str(out), "--use_cpu",
                    "--vocoder_checkpoint", voc_path])
    model, _ = inference.load_acoustic_model(ckpt, "cpu")
    assert isinstance(model, EftsCNN) and model.training_modules
    assert not any(isinstance(m, WNConv1d) for m in model.modules())
    assert not any(p.requires_grad for p in model.parameters())
    voc = inference.load_vocoder(voc_path, "cpu")
    items = [line.strip().split("|") for line in open(corpus["dev"])]
    seqs = [np.asarray(text_to_sequence(t), np.int32) for _, t in items]
    wav, wl = pipeline.synthesize(model, voc, pad_list(seqs), np.asarray([len(s) for s in seqs], np.int32),
                                  device="cpu")
    assert len(os.listdir(out)) == len(items) == 2
    for i, (path, _) in enumerate(items):
        sr, pcm = wavfile.read(out / (os.path.splitext(os.path.basename(path))[0] + "_gen.wav"))
        want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
        assert sr == 22050 and pcm.shape == want.shape
        np.testing.assert_array_equal(pcm, want)


def test_train_cli_trains_the_transformer(corpus, tmp_path):
    """The EFTS-Transformer through the same CLI, one `--set` per key as on
    the card (text and mel buckets of 128); its checkpoint loads in the
    inference CLI's loader with the training modules."""
    outdir = str(tmp_path / "exp_tr")
    trainer = train.main(["--config", corpus["transformer"], "--train_fid_scp", corpus["train"], "--outdir", outdir,
                          "--use_cpu", "--set", "text_bucket=128", "--set", "mel_bucket=128", "--set",
                          "dataset_params.use_phnseq=false"])
    assert isinstance(trainer.state["params"], EftsTransformer) and trainer.state["step"] == 2
    model, config = inference.load_acoustic_model(os.path.join(outdir, "checkpoint-2steps"), "cpu")
    assert isinstance(model, EftsTransformer) and model.training_modules and config["text_bucket"] == 128


def test_train_cli_refuses_more_than_one_device_and_bad_overrides(corpus, tmp_path):
    base = ["--config", corpus["cnn"], "--train_fid_scp", corpus["train"], "--outdir", str(tmp_path), "--use_cpu"]
    # one process is a world of one rank: a mesh of more is refused, not shrunk
    with pytest.raises(ValueError, match="needs 2 ranks and this run has 1"):
        train.main(base + ["--set", "mesh.data=2"])
    with pytest.raises(ValueError, match="needs 4 ranks and this run has 1"):
        train.main(base + ["--set", "mesh.model=4"])
    for bad in ("train_max_steps", "=3", "a..b=1", "batch_size.x=1"):
        with pytest.raises(SystemExit):
            train.main(base + ["--set", bad])
    config = train.apply_overrides({"a": {"b": 1}, "c": 2}, ["a.b=[1, 2]", "a.d.e=x", "c=null", "f=0.5"])
    assert config == {"a": {"b": [1, 2], "d": {"e": "x"}}, "c": None, "f": 0.5}


def test_trainer_keeps_a_bounded_history(corpus, tmp_path, caplog, monkeypatch):
    """`EftsTrainer.HISTORY` bounds the per-step records (a run of a million steps keeps
    the last ones only); each log line still gives its interval's data wait."""
    from efficient_tts_tpu_torch.data.collate import collate_text_mel
    from efficient_tts_tpu_torch.data.dataset import TextMelDataset
    from efficient_tts_tpu_torch.data.loader import infinite_loader
    from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.utils.config import model_config_from_dict

    config = load_config(corpus["cnn"])
    cfg = model_config_from_dict(config)
    ds = TextMelDataset(corpus["train"], wav_path=corpus["wavs"])
    batches = infinite_loader(ds, 3, lambda b: collate_text_mel(b, 16, 64))
    monkeypatch.setattr(EftsTrainer, "HISTORY", 2)
    trainer = EftsTrainer(cfg, optimizer_from_dict(config), batches, outdir=str(tmp_path), train_max_steps=3,
                          save_interval_steps=100, log_interval_steps=1, device="cpu")
    trainer.init_state(train.build_model(cfg, 0, "cpu"))
    with caplog.at_level("INFO", logger="efficient_tts_tpu_torch.train.efts_trainer"):
        trainer.run()
    assert [t["step"] for t in trainer.step_times] == [2, 3]
    assert [m["step"] for m in trainer.metrics_log] == [2, 3]
    assert sum("ms a step" in r.getMessage() for r in caplog.records) == 3
