"""Guards of the port: it imports no JAX and nothing of the JAX package, and
its entry points never fall back to the CPU on their own."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import efficient_tts_tpu_torch
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig, generator_chunked
from efficient_tts_tpu_torch.serve import TTSEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import efficient_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "efficient_tts_tpu" or m.startswith("efficient_tts_tpu.")]
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    expected = [m.name for m in pkgutil.walk_packages(efficient_tts_tpu_torch.__path__,
                                                      "efficient_tts_tpu_torch.")]
    assert n_modules == len(expected) >= 15
    # the training slice's modules, the int8 ops and the benchmarks are among those imported
    for name in ("train.efts_train_step", "train.efts_trainer", "train.optim", "train.checkpoint",
                 "losses.fastspeech", "utils.preemption", "ops.mrf_int8", "ops.probe_matmul",
                 "bench.mrf_fused", "bench.probe_int8", "serve", "bin.serve", "bin.inference",
                 "bench.serving_load", "text", "text.cleaners", "text.mandarin", "utils.config",
                 "data.dataset", "ops.launch_counts", "data.loader", "data.collate", "dsp", "dsp.mel",
                 "dsp.filters", "native", "bin.train", "bench.corpus", "losses.gan", "losses.stft_loss",
                 "train.hifigan_train_step", "train.hifigan_trainer", "bin.train_vocoder", "bin.extract_gta",
                 "models.hifigan_train", "data.device_corpus", "train.torch_optim", "models.duration_model",
                 "train.duration_train_step", "losses.duration", "nn.length_regulator", "nn.postnet",
                 "compat", "compat.torch_import", "compat.torch_export", "bin.convert_checkpoint", "bin.export_torch",
                 "bin.prepare_data", "bin.prepare_databaker", "bin.data_utils", "utils.plotting",
                 "utils.profiling", "parallel", "parallel.distributed", "parallel.mesh", "parallel.sharding",
                 "parallel.tensor_parallel", "parallel.sequence_parallel", "nn.init", "version",
                 "utils.flops"):
        assert f"efficient_tts_tpu_torch.{name}" in expected


EFTS_CFG = EftsCNNConfig(num_symbols=10, symbol_embedding_dim=8, n_channels=8, n_text_encoder_layer=1,
                         n_decoder_layer=1, dropout_rate=0.0)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1,),))


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.bench import serving_load
    from efficient_tts_tpu_torch.bin import inference, serve as serve_cli
    from efficient_tts_tpu_torch.serve import TTSEngine

    ep, vp = init.init_efts(0, EFTS_CFG), init.init_generator(1, VOC_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.efts_cnn_from_jax(ep, EFTS_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.hifigan_generator_from_jax(vp, VOC_CFG)
    em = compat.efts_cnn_from_jax(ep, EFTS_CFG, device="cpu")
    vm = compat.hifigan_generator_from_jax(vp, VOC_CFG, device="cpu")
    text, lengths = np.ones((1, 4), np.int32), np.array([4], np.int32)
    mel = np.zeros((1, 8, 80), np.float32)
    for call in (lambda: pipeline.synthesize(em, vm, text, lengths),
                 lambda: pipeline.synthesize_fixed(em, vm, text, lengths, 32),
                 lambda: pipeline.predict_lengths(em, text, lengths),
                 lambda: pipeline.decode_mel_fixed(em, text, lengths, 32),
                 lambda: pipeline.synthesize_dispatch(em, vm, text, lengths),
                 lambda: pipeline.stream_vocoder(vm, mel[0]),
                 lambda: generator_chunked(vm, mel),
                 lambda: TTSEngine(em, vm),
                 lambda: serve_cli.main(["--random_init"]),
                 lambda: inference.main(["--test_fid_scp", str(tmp_path / "list.txt"), "--checkpoint",
                                         str(tmp_path / "checkpoint"), "--outdir", str(tmp_path / "out")]),
                 lambda: serving_load.build_engine(max_batch=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert TTSEngine(em, vm, device="cpu").device.type == "cpu"
    wav, wl = pipeline.synthesize(em, vm, text, lengths, device="cpu")
    assert wav.shape[0] == 1 and wl.shape == (1,)
    handle, wl = pipeline.synthesize_dispatch(em, vm, text, lengths, device="cpu")
    assert pipeline.fetch(handle).shape == wav.shape
    assert pipeline.decode_mel_fixed(em, text, lengths, 32, device="cpu")[0].device.type == "cpu"
    assert np.concatenate(list(pipeline.stream_vocoder(vm, mel[0], device="cpu"))).shape == (8 * 256,)
    assert generator_chunked(vm, mel, device="cpu").shape == (1, 8 * 256)


TR_CFG = EftsTransformerConfig(num_symbols=10, n_channels=16, n_heads=2, ff_hidden=32, n_text_encoder_layer=1,
                               n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, attn_impl="flash")


def test_transformer_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    tp = init.init_efts_transformer(0, TR_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.efts_transformer_from_jax(tp, TR_CFG)
    tm = compat.efts_transformer_from_jax(tp, TR_CFG, device="cpu")
    vm = compat.hifigan_generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    text, lengths = np.ones((1, 4), np.int32), np.array([4], np.int32)
    for call in (lambda: pipeline.synthesize(tm, vm, text, lengths),
                 lambda: pipeline.synthesize_fixed(tm, vm, text, lengths, 32),
                 lambda: pipeline.predict_lengths(tm, text, lengths)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    wav, wl = pipeline.synthesize(tm, vm, text, lengths, device="cpu")
    assert wav.shape[0] == 1 and wl.shape == (1,)


def test_models_on_another_device_than_the_call_raise():
    em = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu").to("meta")
    vm = compat.hifigan_generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    with pytest.raises(ValueError, match="holds tensors on meta"):
        pipeline.synthesize_fixed(em, vm, np.ones((1, 4)), np.array([4]), 32, device="cpu")


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """The train step, eval step, trainer, training CLI and the loader's
    device prefetch run on the card unless the caller asks for the CPU, and
    never move there on their own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.bin import train
    from efficient_tts_tpu_torch.data.loader import device_prefetch
    from efficient_tts_tpu_torch.train.efts_train_step import make_eval_step, make_train_step
    from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
    from efficient_tts_tpu_torch.train.optim import AdamWarmup
    from efficient_tts_tpu_torch.train.state import create_state

    tx = AdamWarmup()
    for call in (lambda: make_train_step(TR_CFG, tx), lambda: make_eval_step(TR_CFG),
                 lambda: make_train_step(EFTS_CFG, tx),
                 lambda: EftsTrainer(TR_CFG, tx, iter(()), outdir=str(tmp_path)),
                 lambda: compat.efts_transformer_from_jax(init.init_efts_transformer(0, TR_CFG), TR_CFG,
                                                          trainable=True),
                 lambda: compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, trainable=True),
                 lambda: device_prefetch(iter(())),
                 lambda: train.main(["--config", str(tmp_path / "config.yml"), "--train_fid_scp",
                                     str(tmp_path / "train.txt"), "--outdir", str(tmp_path / "exp")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = compat.efts_transformer_from_jax(init.init_efts_transformer(0, TR_CFG), TR_CFG, device="cpu",
                                             trainable=True)
    batch = {"text": np.ones((1, 4), np.int32), "text_lengths": np.array([4]),
             "mel": np.zeros((1, 8, TR_CFG.odim), np.float32), "mel_lengths": np.array([8])}
    state, metrics = make_train_step(TR_CFG, tx, device="cpu")(create_state(model, tx), batch)
    assert state["step"] == 1 and set(metrics) == {"loss", "mel_loss", "duration_loss", "grad_norm"}
    # a model on another device than the step's is refused, not moved
    with pytest.raises(ValueError, match="holds tensors on meta"):
        make_train_step(TR_CFG, tx, device="cpu")(create_state(model.to("meta"), tx), batch)


def test_vocoder_training_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """The GAN step, eval step, state bridge and init, trainer, vocoder CLI
    and GTA extraction run on the card unless the caller asks for the CPU,
    and never move there on their own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.bin import extract_gta, train_vocoder
    from efficient_tts_tpu_torch.train.hifigan_train_step import (init_gan_state, make_gan_eval_step,
                                                                  make_gan_train_step)
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    tx = HiFiGANAdam()
    tree = init.init_gan_state(0, VOC_CFG)
    scp = tmp_path / "wavs.scp"
    scp.write_text("")
    for call in (lambda: make_gan_train_step(VOC_CFG, tx, tx), lambda: make_gan_eval_step(VOC_CFG),
                 lambda: compat.gan_state_from_jax(tree, VOC_CFG, tx, tx),
                 lambda: compat.generator_from_jax(tree["gen"]["params"], VOC_CFG),
                 lambda: init_gan_state(0, VOC_CFG, tx, tx),
                 lambda: HiFiGANTrainer(None, None, iter(()), outdir=str(tmp_path / "exp")),
                 lambda: train_vocoder.main(["--wav_scp", str(scp), "--outdir", str(tmp_path / "voc")]),
                 lambda: extract_gta.main(["--fid_scp", str(scp), "--checkpoint", str(tmp_path / "checkpoint"),
                                           "--outdir", str(tmp_path / "gta")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state = compat.gan_state_from_jax(tree, VOC_CFG, tx, tx, device="cpu")
    assert state["gen"]["params"].conv_pre.v.device.type == "cpu" and "ema" not in state
    # a state on another device than the step's is refused, not moved
    step = make_gan_train_step(VOC_CFG, tx, tx, device="cpu")
    state["disc"]["params"].to("meta")
    batch = {"mel": np.zeros((1, 8, 80), np.float32), "audio": np.zeros((1, 2048), np.float32),
             "mel_loss": np.zeros((1, 8, 80), np.float32)}
    with pytest.raises(ValueError, match="holds tensors on meta"):
        step(state, batch)


def test_device_corpus_and_duration_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """The device corpus, its batcher and the DurationModel's state and step
    run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from scipy.io.wavfile import write as wav_write

    from efficient_tts_tpu_torch.data.device_corpus import load_corpus, make_device_batch_fn
    from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
    from efficient_tts_tpu_torch.train.duration_train_step import init_duration_state, make_duration_train_step
    from efficient_tts_tpu_torch.train.optim import AdamWarmup

    wav = str(tmp_path / "a.wav")
    wav_write(wav, 22050, (np.sin(np.arange(3000) / 9.0) * 9000).astype(np.int16))
    cfg = DurationModelConfig(idim=8, duration_predictor_chans=8)
    tx = AdamWarmup()
    for call in (lambda: load_corpus([wav], segment_size=2048), lambda: make_device_batch_fn(2, 2048),
                 lambda: init_duration_state(0, cfg, tx), lambda: make_duration_train_step(cfg, tx)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    corpus = load_corpus([wav], segment_size=2048, device="cpu")
    assert corpus["wav"].device.type == "cpu" and corpus["wav"].shape == (1, 3072)
    assert make_device_batch_fn(2, 2048, device="cpu")(corpus, 0)["audio"].shape == (2, 2048)
    state = init_duration_state(0, cfg, tx, device="cpu")
    batch = {"ppg": np.zeros((1, 4, 8), np.float32), "lengths": np.array([4]), "durations": np.ones((1, 4), np.int32),
             "spkids": np.zeros((1,), np.int32)}
    state, metrics = make_duration_train_step(cfg, tx, device="cpu")(state, batch)
    assert state["step"] == 1 and set(metrics) == {"loss"}
    # a model on another device than the step's is refused, not moved
    state["params"].to("meta")
    with pytest.raises(ValueError, match="holds tensors on meta"):
        make_duration_train_step(cfg, tx, device="cpu")(state, batch)


def test_reference_readers_default_to_cuda_and_raise_without_a_card():
    """`compat.torch_import`'s readers and `utils/profiling.time_step` run on
    the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.compat import torch_export, torch_import
    from efficient_tts_tpu_torch.models.hifigan_train import Discriminators
    from efficient_tts_tpu_torch.utils.profiling import time_step

    model = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu", trainable=True)
    efts_sd = torch_export.efts_cnn_to_state_dict(model)
    gen = compat.generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    gen_sd = torch_export.hifigan_generator_to_state_dict(gen)
    disc = Discriminators()
    mpd_sd, msd_sd = torch_export.hifigan_mpd_to_state_dict(disc.mpd), torch_export.hifigan_msd_to_state_dict(disc.msd)
    for call in (lambda: torch_import.efts_cnn_from_state_dict(efts_sd, EFTS_CFG),
                 lambda: torch_import.efts_cnn_from_state_dict(efts_sd, EFTS_CFG, trainable=True),
                 lambda: torch_import.hifigan_generator_from_state_dict(gen_sd, VOC_CFG),
                 lambda: torch_import.hifigan_train_generator_from_state_dict(gen_sd, VOC_CFG),
                 lambda: torch_import.hifigan_mpd_from_state_dict(mpd_sd),
                 lambda: torch_import.hifigan_msd_from_state_dict(msd_sd),
                 lambda: time_step(lambda: None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert torch_import.efts_cnn_from_state_dict(efts_sd, EFTS_CFG, device="cpu").text_key.weight.device.type == "cpu"
    assert torch_import.hifigan_mpd_from_state_dict(mpd_sd, device="cpu").discriminators[0].conv_post.g.device.type \
        == "cpu"


def test_tooling_clis_are_host_tools_that_touch_no_device(tmp_path, monkeypatch):
    """The conversion, export and data CLIs run on the host: with any use of
    CUDA made to raise, each runs to its end."""
    import yaml

    from efficient_tts_tpu_torch.bin import (convert_checkpoint, data_utils, export_torch, prepare_data,
                                             prepare_databaker)
    from efficient_tts_tpu_torch.compat import torch_export
    from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint

    def no_cuda(*args, **kwargs):
        raise AssertionError("a host tool initialized CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    model = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu", trainable=True)
    pkl = str(tmp_path / "reference.pkl")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in torch_export.efts_cnn_to_state_dict(model).items()},
                "steps": 5, "epochs": 1}, pkl)
    config = tmp_path / "model.yml"
    config.write_text(yaml.safe_dump({"model_name": "EfficientTTSCNN",
                                      "model_params": {"num_symbols": 10, "symbol_embedding_dim": 8, "n_channels": 8,
                                                       "n_text_encoder_layer": 1, "n_decoder_layer": 1}}))
    path = convert_checkpoint.main(["--torch_checkpoint", pkl, "--outdir", str(tmp_path / "imported"),
                                    "--config", str(config)])
    export_torch.main(["--checkpoint", path, "--out", str(tmp_path / "exported.pkl"), "--config", str(config)])
    gen_ckpt = save_checkpoint(str(tmp_path / "voc"), {
        "gen": {"params": compat.generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")},
        "step": 3})
    (tmp_path / "voc" / "config.yml").write_text(yaml.safe_dump({"vocoder_params": {
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]]}}))
    export_torch.main(["--model", "HiFiGANGenerator", "--checkpoint", gen_ckpt, "--out", str(tmp_path / "g.pt"),
                       "--fold_weight_norm"])
    files = tmp_path / "all.txt"
    files.write_text("".join(f"w{i}.wav|text {i}\n" for i in range(6)))
    prepare_data.main(["--filelist", str(files), "--outdir", str(tmp_path / "data"), "--dev", "1", "--test", "1"])
    assert data_utils.main(["split", str(files), str(tmp_path / "a.txt"), str(tmp_path / "b.txt")]) == 0
    (tmp_path / "db" / "ProsodyLabeling").mkdir(parents=True)
    (tmp_path / "db" / "ProsodyLabeling" / "000001-010000.txt").write_text("000001\tx\n\tka2 er2\n")
    prepare_databaker.main(["--db_root", str(tmp_path / "db"), "--outdir", str(tmp_path / "databaker"), "--dev", "0",
                            "--test", "0"])
    written = (tmp_path / "exported.pkl", tmp_path / "g.pt", tmp_path / "data" / "train.txt",
               tmp_path / "databaker" / "train.txt")
    assert all(os.path.exists(p) for p in written)


def test_parallel_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.parallel import initialize_multihost, rank_device

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    em = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu")
    vm = compat.hifigan_generator_from_jax(init.init_generator(1, VOC_CFG), VOC_CFG, device="cpu")
    text, lengths = np.ones((2, 4), np.int32), np.array([4, 3], np.int32)
    for call in (initialize_multihost, rank_device,
                 lambda: initialize_multihost("localhost:1", 2, 0),
                 lambda: rank_device(index=0),
                 lambda: pipeline.synthesize_fixed_sharded(em, vm, text, lengths, 32, None),
                 lambda: pipeline.synthesize(em, vm, text, lengths, mesh=None),
                 lambda: TTSEngine(em, vm, mesh=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert rank_device("cpu").type == "cpu"
    # asked for the CPU, it still needs a rendezvous: none is made up
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="together"):
        initialize_multihost("localhost:1", None, 0, device="cpu")


def test_multi_rank_training_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """The sharded states, the steps and trainers over a mesh, the batch
    split and its prefetch, and the re-initialization run on the card unless
    the caller asks for the CPU, and never move there on their own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable here")
    from efficient_tts_tpu_torch.data.loader import device_prefetch
    from efficient_tts_tpu_torch.nn.init import initialize
    from efficient_tts_tpu_torch.train.efts_train_step import make_eval_step, make_train_step, shard_batch, shard_state
    from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
    from efficient_tts_tpu_torch.train.hifigan_train_step import make_gan_train_step, shard_gan_state
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.optim import AdamWarmup, HiFiGANAdam

    # a 2 x 1 mesh's view from data row 0: every call raises before a collective
    mesh = type("Mesh", (), {"shape": {"data": 2, "model": 1}, "member": True, "data_index": 0, "model_index": 0,
                             "data_group": None, "model_group": None, "group": None})()
    tx, gtx = AdamWarmup(), HiFiGANAdam()
    model = compat.efts_cnn_from_jax(init.init_efts(0, EFTS_CFG), EFTS_CFG, device="cpu", trainable=True)
    batch = {"text": np.ones((2, 4), np.int32), "text_lengths": np.array([4, 3]),
             "mel": np.zeros((2, 8, EFTS_CFG.odim), np.float32), "mel_lengths": np.array([8, 6])}
    for call in (lambda: shard_state(model, tx, mesh), lambda: shard_gan_state(0, VOC_CFG, gtx, gtx, mesh),
                 lambda: make_train_step(EFTS_CFG, tx, mesh=mesh), lambda: make_eval_step(EFTS_CFG, mesh=mesh),
                 lambda: make_gan_train_step(VOC_CFG, gtx, gtx, mesh=mesh),
                 lambda: shard_batch(batch, mesh), lambda: device_prefetch(iter(()), mesh=mesh),
                 lambda: EftsTrainer(EFTS_CFG, tx, iter(()), outdir=str(tmp_path), mesh=mesh),
                 lambda: HiFiGANTrainer(None, None, iter(()), outdir=str(tmp_path / "voc"), mesh=mesh),
                 lambda: initialize(model, "xavier_uniform", torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert shard_batch(batch, mesh, device="cpu")["text"].shape == (1, 4)
    # a model on another device than the call's is refused, not moved
    with pytest.raises(ValueError, match="holds tensors on meta"):
        initialize(model.to("meta"), "xavier_uniform", torch.Generator(), device="cpu")
