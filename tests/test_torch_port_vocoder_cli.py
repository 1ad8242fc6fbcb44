"""The vocoder's data, training CLI and GTA extraction on the CPU, and inference from what they wrote.

A seeded synthetic corpus (`bench/corpus.py`: 6 train and 2 dev
utterances of 0.4-1.0 s), a narrow HiFi-GAN (initial channel 32, one
kernel 3, dilations (1, 2), segment 2048) with the full discriminators, and
a tiny EFTS-CNN (24 channels, one res-conv layer a block):
  * `MelAudioSegmentDataset` items equal the JAX package's for the same
    files and seed, bit for bit: the random crops, the peak-normalized
    audio, the mel and the full-band loss mel, and in GTA fine-tuning the
    crop of the stored mel; `collate_mel_audio` equals JAX's;
  * `bin.train_vocoder --use_cpu`: 2 steps at B=2 with an EMA of 0.99 and a
    dev set, finite metrics, evals at steps 1 and 2, checkpoints and
    `config.yml`; an automatic resume without `--ema_decay` (the saved EMA
    dropped with a warning), then an explicit `--resume` with it (the EMA
    seeded from the restored generator, with a warning); the last checkpoint
    handed to `bin.inference`, whose wavs equal `pipeline.synthesize` on the
    folded EMA generator PCM for PCM, its vocoder the fold bit for bit;
  * `bin.extract_gta --use_cpu` on an EFTS-CNN trainer checkpoint: one
    [n_mels, T2] mel per utterance, T2 the utterance's frame count, equal to
    the same forward on that utterance alone (atol 1e-5), and the lengths
    `MelAudioSegmentDataset(fine_tuning=True)` then reads; one fine-tuning
    step of the CLI on them.
Each test removes the checkpoints it wrote once it has read them (each
holds the full discriminators, about 0.8 GB), and the module's runs go at
its end.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from efficient_tts_tpu.data.collate import collate_mel_audio as jcollate_mel_audio
from efficient_tts_tpu.data.dataset import MelAudioSegmentDataset as JMelAudioSegmentDataset
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.bench.corpus import make_corpus
from efficient_tts_tpu_torch.bin import extract_gta, inference, train_vocoder
from efficient_tts_tpu_torch.data.collate import collate_mel_audio, collate_text_mel
from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset, TextMelDataset
from efficient_tts_tpu_torch.dsp.mel import num_frames
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from efficient_tts_tpu_torch.train.efts_train_step import make_eval_step
from efficient_tts_tpu_torch.text import text_to_sequence
from efficient_tts_tpu_torch.utils.config import dump_config, load_config
from efficient_tts_tpu_torch.utils.masks import pad_list

VOC_PARAMS = {"upsample_initial_channel": 32, "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]],
              "segment_size": 2048}
CNN_PARAMS = dict(num_symbols=148, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=1,
                  n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module: Tier-1 runs six
    workers on the host's cores, and the full-width discriminators' convs
    at one thread a core each ran 8-17x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder")
    paths = make_corpus(str(root), n_train=6, n_dev=2, seed=2, min_s=0.4, max_s=1.0)
    for name in ("train", "dev"):
        with open(paths[name]) as f:
            wavs = [os.path.join(str(root), line.split("|")[0]) for line in f if line.strip()]
        paths[name + "_wavs"] = wavs
        paths[name + "_scp"] = str(root / f"{name}_wavs.scp")
        with open(paths[name + "_scp"], "w") as f:
            f.writelines(w + "\n" for w in wavs)
    paths["config"] = str(root / "vocoder.json")
    with open(paths["config"], "w") as f:
        json.dump({"vocoder_params": VOC_PARAMS}, f)
    # an EFTS-CNN trainer checkpoint (weight norm as {v, g}, training modules)
    # with the config.yml beside it, as bin.train writes them
    config = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                      "efficient_tts_tpu_torch", "configs", "lj_efts_cnn_char.yaml"))
    config.update(model_name="EfficientTTSCNN", model_params=CNN_PARAMS)
    config["dataset_params"]["wav_path"] = paths["wavs"]
    cfg = EftsCNNConfig(**CNN_PARAMS)
    model = compat.efts_cnn_from_jax(init.init_efts(3, cfg), cfg, device="cpu", trainable=True)
    exp = str(root / "exp_cnn")
    dump_config(config, exp)
    paths["efts_checkpoint"] = save_checkpoint(exp, {"params": model, "opt_state": {}, "step": 5})
    paths["root"] = root
    return paths


def _items_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_segment_dataset_matches_jax(corpus, tmp_path):
    files = corpus["train_wavs"]
    port, ref = MelAudioSegmentDataset(files, segment_size=2048), JMelAudioSegmentDataset(files, segment_size=2048)
    assert port.files == ref.files and not port.deterministic_items
    batch = []
    for epoch in range(2):  # the crops move from one pass to the next
        for i in range(len(files)):
            item = port[i]
            _items_equal(item, ref[i])
            assert item[0].shape == item[2].shape == (8, 80) and item[1].shape == (2048,)
            batch.append(item)
    for k, v in jcollate_mel_audio(batch[:3]).items():
        assert np.array_equal(collate_mel_audio(batch[:3])[k], v)
    whole = MelAudioSegmentDataset(files, split=False, shuffle=False)
    assert whole.deterministic_items and whole[0][1].shape[0] == wavfile.read(files[0])[1].shape[0]
    # GTA fine-tuning: the stored [n_mels, T2] mel cropped at the audio's frame
    rng = np.random.default_rng(0)
    for f in files:
        n = wavfile.read(f)[1].shape[0]
        np.save(tmp_path / (os.path.splitext(os.path.basename(f))[0] + ".npy"),
                rng.standard_normal((80, num_frames(n))).astype(np.float32))
    port = MelAudioSegmentDataset(files, segment_size=2048, fine_tuning=True, base_mels_path=str(tmp_path))
    ref = JMelAudioSegmentDataset(files, segment_size=2048, fine_tuning=True, base_mels_path=str(tmp_path))
    for i in range(len(files)):
        item = port[i]
        _items_equal(item, ref[i])
        assert item[0].shape == (8, 80) and item[1].shape == (2048,)
    with pytest.raises(ValueError, match="base_mels_path"):
        MelAudioSegmentDataset(files, fine_tuning=True)


def _cli(corpus, outdir, *extra):
    return ["--use_cpu", "--config", corpus["config"], "--wav_scp", corpus["train_scp"], "--outdir", outdir,
            "--batch_size", "2", "--log_interval_steps", "1", *extra]


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _warned(argv):
    """(the trainer `train_vocoder.main(argv)` returns, its warnings)."""
    handler, root = _Warnings(), logging.getLogger()
    root.addHandler(handler)
    try:
        return train_vocoder.main(argv), " ".join(handler.messages)
    finally:
        root.removeHandler(handler)


@pytest.fixture(scope="module")
def vocoder_runs(corpus):
    """2 steps with an EMA and evals; an automatic resume to 3 without the
    EMA; an explicit resume to 4 with it."""
    outdir = str(corpus["root"] / "exp_vocoder")
    first = train_vocoder.main(_cli(corpus, outdir, "--dev_wav_scp", corpus["dev_scp"], "--train_max_steps", "2",
                                    "--save_interval_steps", "2", "--eval_interval_steps", "1", "--ema_decay",
                                    "0.99", "--max_keep_checkpoints", "2"))
    listing = sorted(os.listdir(outdir))
    second = _warned(_cli(corpus, outdir, "--train_max_steps", "3", "--save_interval_steps", "3"))
    third = _warned(_cli(corpus, outdir, "--train_max_steps", "4", "--ema_decay", "0.99", "--resume",
                         os.path.join(outdir, "checkpoint-3steps")))
    yield {"outdir": outdir, "first": first, "listing": listing, "second": second, "third": third}
    shutil.rmtree(outdir)


def test_train_vocoder_cli_trains_evals_and_checkpoints(vocoder_runs):
    first, outdir = vocoder_runs["first"], vocoder_runs["outdir"]
    assert first.state["step"] == 2 and [t["step"] for t in first.step_times] == [1, 2]
    assert [m["step"] for m in first.metrics_log] == [1, 2]
    assert set(first.metrics_log[0]) == {"step", "d_loss", "d_mpd", "d_msd", "g_loss", "mel_l1", "fm", "adv"}
    assert all(np.isfinite(v) for m in first.metrics_log for v in m.values())
    assert [e["step"] for e in first.eval_log] == [1, 2] and all(np.isfinite(e["mel_l1"]) for e in first.eval_log)
    assert len(first.eval_batches) == 1 and first.eval_batches[0]["audio"].shape == (2, 2048)
    assert "ema" in first.state and first.state["gen"]["opt_state"]["count"] == 2
    assert vocoder_runs["listing"] == ["checkpoint-2steps", "config.yml"]
    assert load_config(os.path.join(outdir, "config.yml"))["vocoder_params"] == VOC_PARAMS
    saved = torch.load(os.path.join(outdir, "checkpoint-2steps"), map_location="cpu", weights_only=True)
    assert set(saved) == {"gen", "disc", "step", "ema"} and saved["step"] == 2
    assert "msd.discriminators.0.convs.0.u" in saved["disc"]["params"]


def test_train_vocoder_cli_resumes_with_ema_reconciliation(vocoder_runs):
    outdir = vocoder_runs["outdir"]
    second, warned = vocoder_runs["second"]
    assert "will be dropped" in warned
    assert second.state["step"] == 3 and "ema" not in second.state and [t["step"] for t in second.step_times] == [3]
    third, warned = vocoder_runs["third"]
    assert "seeding the EMA" in warned
    assert third.state["step"] == 4 and "ema" in third.state and [t["step"] for t in third.step_times] == [4]
    saved = torch.load(os.path.join(outdir, "checkpoint-4steps"), map_location="cpu", weights_only=True)
    assert saved["step"] == 4 and "ema" in saved
    assert "ema" not in torch.load(os.path.join(outdir, "checkpoint-3steps"), map_location="cpu", weights_only=True)


def test_inference_cli_reads_the_trained_vocoder(vocoder_runs, corpus, tmp_path):
    third, outdir = vocoder_runs["third"][0], vocoder_runs["outdir"]
    voc_ckpt = os.path.join(outdir, "checkpoint-4steps")
    voc = inference.load_vocoder(voc_ckpt, torch.device("cpu"))
    folded = third.state["ema"].fold()
    assert voc.cfg == folded.cfg and voc.cfg.upsample_initial_channel == 32
    for k, v in folded.state_dict().items():
        assert torch.equal(voc.state_dict()[k], v), k
    with open(corpus["dev"]) as f:
        items = [line.strip().split("|") for line in f if line.strip()]
    test_scp = str(tmp_path / "test.txt")
    with open(test_scp, "w") as f:
        f.writelines(f"{p}|{t}\n" for p, t in items)
    inference.main(["--use_cpu", "--test_fid_scp", test_scp, "--checkpoint", corpus["efts_checkpoint"], "--outdir",
                    str(tmp_path / "wavs"), "--vocoder_checkpoint", voc_ckpt])
    model, _ = inference.load_acoustic_model(corpus["efts_checkpoint"], torch.device("cpu"))
    seqs = [np.asarray(text_to_sequence(t), np.int32) for _, t in items]
    wav, wl = pipeline.synthesize(model, folded, pad_list(seqs), np.asarray([len(s) for s in seqs], np.int32),
                                  device="cpu")
    for i, (path, _) in enumerate(items):
        sr, pcm = wavfile.read(str(tmp_path / "wavs" / (os.path.splitext(os.path.basename(path))[0] + "_gen.wav")))
        want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
        assert sr == 22050 and np.array_equal(pcm, want)


def test_extract_gta_writes_the_lengths_the_dataset_reads(corpus, tmp_path):
    gta = str(tmp_path / "gta")
    n = extract_gta.main(["--use_cpu", "--fid_scp", corpus["train"], "--checkpoint", corpus["efts_checkpoint"],
                          "--outdir", gta, "--batch_size", "4"])
    files = corpus["train_wavs"]
    assert n == len(files) == len(os.listdir(gta))
    config = load_config(os.path.join(os.path.dirname(corpus["efts_checkpoint"]), "config.yml"))
    cfg = EftsCNNConfig(**CNN_PARAMS)
    model = EftsCNN(cfg, training_modules=True)
    load_checkpoint(corpus["efts_checkpoint"], {"params": model}, load_only_params=True)
    eval_step = make_eval_step(cfg, device="cpu")
    ds = TextMelDataset(corpus["train"], **config["dataset_params"])
    for item, (wav_path, _) in zip([ds[i] for i in range(len(ds))], ds.items):
        name = os.path.splitext(os.path.basename(wav_path))[0]
        mel = np.load(os.path.join(gta, name + ".npy"))
        frames = num_frames(wavfile.read(os.path.join(corpus["wavs"], name + ".wav"))[1].shape[0])
        assert mel.shape == (80, frames) == (80, item[1].shape[0]) and mel.dtype == np.float32
        alone = eval_step(model, collate_text_mel([item], sort=False))["mel_pred"][0, :frames].T.numpy()
        np.testing.assert_allclose(mel, alone, rtol=0, atol=1e-5)
    ds = MelAudioSegmentDataset(files, segment_size=2048, fine_tuning=True, base_mels_path=gta)
    for i in range(len(files)):
        mel, audio, mel_loss = ds[i]
        assert mel.shape == mel_loss.shape == (8, 80) and audio.shape == (2048,)
    tuned = train_vocoder.main(_cli(corpus, str(tmp_path / "exp_ft"), "--train_max_steps", "1", "--fine_tuning",
                                    "--base_mels_path", gta))
    assert tuned.state["step"] == 1 and all(np.isfinite(v) for v in tuned.metrics_log[0].values())
    shutil.rmtree(tmp_path / "exp_ft")


def test_device_corpus_on_raises(corpus, tmp_path):
    """`--device_corpus on` with `--fine_tuning` raises, naming the GTA mels
    the device corpus does not hold, before any state is built."""
    with pytest.raises(ValueError, match="GTA mels"):
        train_vocoder.main(_cli(corpus, str(tmp_path / "exp"), "--device_corpus", "on", "--fine_tuning",
                                "--base_mels_path", str(tmp_path / "gta")))
    assert not os.path.exists(tmp_path / "exp")


def test_trainer_divergence_guard_and_bounded_history(tmp_path):
    """A non-finite g_loss saves `diverged-state-{step}`, which
    `latest_checkpoint` does not see, and raises; the logs keep the last
    HISTORY entries."""
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train.hifigan_train_step import init_gan_state
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    cfg = HiFiGANConfig(**{k: tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else
                           tuple(v) if isinstance(v, list) else v for k, v in VOC_PARAMS.items()})
    tx = HiFiGANAdam()
    state = init_gan_state(0, cfg, tx, tx, device="cpu")

    def fake_step(state, batch):  # the step's contract, with a loss that turns NaN at step 3
        state["step"] += 1
        g = float("nan") if state["step"] == 3 else 1.0
        return state, {k: torch.tensor(v) for k, v in (("g_loss", g), ("d_loss", 1.0), ("mel_l1", 0.5))}

    batches = ((0, {}) for _ in range(10))
    trainer = HiFiGANTrainer(fake_step, state, batches, outdir=str(tmp_path), train_max_steps=10,
                             save_interval_steps=100, log_interval_steps=1, device="cpu")
    trainer.step_times = type(trainer.step_times)(maxlen=2)
    with pytest.raises(FloatingPointError, match="g_loss=nan at step 3"):
        trainer.run()
    # the readback is one step late: step 3's metrics are read after step 4 ran
    assert trainer.state["step"] == 4 and [m["step"] for m in trainer.metrics_log] == [1, 2, 3]
    assert os.listdir(tmp_path) == ["diverged-state-3"] and ckpt.latest_checkpoint(str(tmp_path)) is None
    assert HiFiGANTrainer.HISTORY == 1000 and trainer.metrics_log.maxlen == trainer.eval_log.maxlen == 1000
    # step 4 raised before it was logged; two entries kept of 1-3
    assert [t["step"] for t in trainer.step_times] == [2, 3]
    os.remove(tmp_path / "diverged-state-3")
