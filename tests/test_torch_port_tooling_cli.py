"""The port's tooling CLIs, eval plots and profiling against the JAX package, on the CPU.

Every CLI runs in-process through `main(argv)`:
  * `bin/convert_checkpoint.py` on reference `.pkl` files written here with
    `torch.save` (the JAX exporter's state dict of a seeded tiny EFTS-CNN,
    weight-normed and folded by the bridge's f64 fold), then `bin/inference.py
    --use_cpu` on what it wrote: PCM equal, sample for sample, to
    `pipeline.synthesize` on the bridged inference model; the checkpoint
    restores into a fresh training state as `bin/train.py` builds it. A
    reference generator file converts into a checkpoint that the vocoder
    loader and `HiFiGANTrainer.load` read;
  * `bin/export_torch.py`'s three modes on port checkpoints: file names, the
    `steps` / `epoch` fields, and arrays byte-equal to the JAX exporter's on
    the bridged trees;
  * `bin/data_utils.py`, `bin/prepare_databaker.py` and `bin/prepare_data.py`'s
    splits: output files byte-identical to the JAX CLIs' on the same inputs;
    `prepare_data --extract_mels` on three short seeded wavs: caches equal
    to `TextMelDataset.get_mel` bit for bit, and to the JAX CLI's per-file
    job within 1e-3 absolute (the data tests' bound between the native and
    numpy mel paths; both sides take the native library when it builds, and
    then agree exactly);
  * `EftsTrainer._plot_diagnostics`: the file names JAX's trainer writes on
    the same eval batch, and the arrays each side hands the save functions
    (recorded) within the eval step's tolerances (rtol = atol = 1e-5, 1e-4
    for the IMV, as `test_torch_port_cnn_training.py` holds the forward);
    real PNGs for one utterance; without matplotlib one warning and no image;
  * `utils/profiling.py`: `time_step` positive on the CPU, `trace` writes a
    Chrome trace.
Sizes: EFTS-CNN at 32 channels and 1/1/1 res-conv layers, 148 symbols, a
generator of 32 initial channels.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from efficient_tts_tpu.bin import data_utils as jdata_utils
from efficient_tts_tpu.bin import prepare_data as jprepare_data
from efficient_tts_tpu.bin import prepare_databaker as jprepare_databaker
from efficient_tts_tpu.compat import torch_export as jexport
from efficient_tts_tpu.models import efficient_tts as je
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.train import efts_train_step as jstep
from efficient_tts_tpu.train.efts_trainer import EftsTrainer as JEftsTrainer
from efficient_tts_tpu.utils import plotting as jplotting
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.bin import (convert_checkpoint, data_utils, export_torch, inference, prepare_data,
                                         prepare_databaker)
from efficient_tts_tpu_torch.compat import torch_export
from efficient_tts_tpu_torch.data.dataset import TextMelDataset
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.nn.layers import Conv1d, WNConv1d, fold_weight_norm
from efficient_tts_tpu_torch.text import text_to_sequence
from efficient_tts_tpu_torch.train import checkpoint as ckpt
from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
from efficient_tts_tpu_torch.train.state import create_state
from efficient_tts_tpu_torch.utils import plotting, profiling
from efficient_tts_tpu_torch.utils.masks import pad_list

CFG = EftsCNNConfig(num_symbols=148, odim=80, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=1,
                    n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True)
VOC_CFG = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))
ITEMS = [("wavs/a.wav", "Hello there."), ("wavs/b.wav", "A longer sentence, to synthesize."), ("wavs/c.wav", "Hi.")]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module (Tier-1 runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _plain(obj):
    return json.loads(json.dumps(dataclasses.asdict(obj)))


def _write_yaml(path, config):
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return str(path)


def _assert_same_state_dict(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k


def _loaded(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def _as_numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


class _NoMoments:
    def init(self, params):
        return {}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The seeded EFTS-CNN tree (weight norm with scaled g), its model config
    file, a reference vocoder file with its config, and a filelist."""
    root = tmp_path_factory.mktemp("tooling")
    tree = init.init_efts(0, CFG)
    tree["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
    rng = np.random.default_rng(1)
    for block in ("text_encoder", "mel_encoder", "decoder"):
        for layer in tree[block]["layers"]:
            layer["g"] = (layer["g"] * rng.uniform(0.5, 1.5, layer["g"].shape)).astype(np.float32)
    model_yaml = _write_yaml(root / "model.yml", {"model_name": "EfficientTTSCNN", "model_params": _plain(CFG)})
    gen = compat.generator_from_jax(init.init_generator(2, VOC_CFG), VOC_CFG, device="cpu")
    (root / "voc").mkdir()
    voc = str(root / "voc" / "generator_v1")
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in
                              torch_export.hifigan_generator_to_state_dict(gen).items()}}, voc)
    _write_yaml(root / "voc" / "config.yml", {"vocoder_params": _plain(VOC_CFG)})
    scp = root / "test.txt"
    scp.write_text("".join(f"{p}|{t}\n" for p, t in ITEMS))
    return {"root": root, "tree": tree, "model_yaml": model_yaml, "gen": gen, "voc": voc, "scp": str(scp)}


def _reference_pkl(path, sd, steps=321, epochs=3):
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, "steps": steps,
                "epochs": epochs}, path)
    return str(path)


@pytest.mark.parametrize("folded", [False, True], ids=["weight_normed", "folded"])
def test_convert_checkpoint_then_inference_matches_the_bridged_model(work, tmp_path, folded):
    tree = fold_weight_norm(work["tree"]) if folded else work["tree"]
    pkl = _reference_pkl(tmp_path / "checkpoint-321steps.pkl",
                         jexport.efts_cnn_to_state_dict(tree, _jcfg(je.EftsCNNConfig, CFG)))
    out = tmp_path / "imported"
    path = convert_checkpoint.main(["--torch_checkpoint", pkl, "--outdir", str(out), "--config", work["model_yaml"]])
    assert os.path.basename(path) == "checkpoint-321steps" and not (out / "config.yml").exists()
    saved = ckpt.read_checkpoint(path)
    assert saved["step"] == 321 and saved["opt_state"]["count"] == 0
    assert all(not v.any() for v in saved["opt_state"]["mu"].values())
    assert ("decoder.layers.0.weight" in saved["params"]) == folded
    assert ("decoder.layers.0.v" in saved["params"]) != folded
    # it restores into the training state bin/train.py builds for --resume
    # (a folded file's layers are plain: the config says so)
    cfg = dataclasses.replace(CFG, use_weight_norm=not folded)
    state = create_state(compat.efts_cnn_from_jax(init.init_efts(7, cfg), cfg, device="cpu", trainable=True),
                         optimizer_from_dict({}))
    ckpt.load_checkpoint(path, state)
    assert state["step"] == 321
    assert isinstance(state["params"].decoder.layers[0], Conv1d if folded else WNConv1d)

    # the user puts the config beside the checkpoint; the inference CLI reads it
    _write_yaml(out / "config.yml", {"model_name": "EfficientTTSCNN", "model_params": _plain(CFG)})
    wavs = tmp_path / "wavs"
    inference.main(["--test_fid_scp", work["scp"], "--checkpoint", path, "--outdir", str(wavs),
                    "--vocoder_checkpoint", work["voc"], "--batch_size", "3", "--use_cpu"])
    model = compat.efts_cnn_from_jax(work["tree"], CFG, device="cpu")
    voc = inference.load_vocoder(work["voc"], "cpu")
    seqs = [np.asarray(text_to_sequence(t), np.int32) for _, t in ITEMS]
    wav, wl = pipeline.synthesize(model, voc, pad_list(seqs), np.asarray([len(s) for s in seqs], np.int32),
                                  device="cpu")
    for i, (p, _) in enumerate(ITEMS):
        sr, pcm = wavfile.read(wavs / (os.path.splitext(os.path.basename(p))[0] + "_gen.wav"))
        want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
        assert sr == VOC_CFG.sampling_rate and pcm.shape == want.shape and want.shape[0] > 0
        np.testing.assert_array_equal(pcm, want)


def test_convert_checkpoint_reads_a_generator_file_for_the_vocoder_cli_and_trainer(work, tmp_path):
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.hifigan_train_step import init_gan_state
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    voc_yaml = os.path.join(os.path.dirname(work["voc"]), "config.yml")
    path = convert_checkpoint.main(["--torch_checkpoint", work["voc"], "--model", "HiFiGANGenerator", "--outdir",
                                    str(tmp_path / "voc"), "--config", voc_yaml])
    assert os.path.basename(path) == "checkpoint-0steps"
    saved = ckpt.read_checkpoint(path)
    assert sorted(saved) == ["gen", "step"] and saved["gen"]["opt_state"]["count"] == 0
    _write_yaml(tmp_path / "voc" / "config.yml", {"vocoder_params": _plain(VOC_CFG)})
    want = work["gen"].fold(device="cpu").state_dict()
    got = inference.load_vocoder(path, "cpu").state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the vocoder trainer resumes from it, its discriminators as seeded
    state = init_gan_state(0, VOC_CFG, HiFiGANAdam(), HiFiGANAdam(), ema_decay=0.9, device="cpu")
    disc = {k: v.clone() for k, v in state["disc"]["params"].state_dict().items()}
    trainer = HiFiGANTrainer(None, state, iter(()), outdir=str(tmp_path / "exp"), device="cpu")
    trainer.load(path)
    gen_sd, ema_sd = trainer.state["gen"]["params"].state_dict(), trainer.state["ema"].state_dict()
    assert all(torch.equal(gen_sd[k], v) and torch.equal(ema_sd[k], v) for k, v in work["gen"].state_dict().items())
    assert all(torch.equal(trainer.state["disc"]["params"].state_dict()[k], v) for k, v in disc.items())
    assert trainer.state["step"] == 0


@pytest.fixture(scope="module")
def vocoder_checkpoint(tmp_path_factory):
    """A vocoder trainer's checkpoint (generator, discriminators, an EMA that
    differs from the generator) at step 57, with its config.yml."""
    root = tmp_path_factory.mktemp("voc_ckpt")
    tree = init.init_gan_state(3, VOC_CFG, ema=True)
    tree["ema"] = init.init_generator(9, VOC_CFG)
    tree["step"] = 57
    state = compat.gan_state_from_jax(tree, VOC_CFG, _NoMoments(), _NoMoments(), device="cpu")
    path = ckpt.save_checkpoint(str(root), state)
    _write_yaml(root / "config.yml", {"vocoder_params": _plain(VOC_CFG)})
    return path, compat.gan_state_to_jax(state)


def test_export_torch_efts_cnn(work, tmp_path):
    model = compat.efts_cnn_from_jax(work["tree"], CFG, device="cpu", trainable=True)
    path = ckpt.save_checkpoint(str(tmp_path), {"params": model, "opt_state": None, "step": 88})
    _write_yaml(tmp_path / "config.yml", {"model_name": "EfficientTTSCNN", "model_params": _plain(CFG)})
    jcfg = _jcfg(je.EftsCNNConfig, CFG)
    for fold in (False, True):
        out = str(tmp_path / f"export_{fold}.pkl")
        assert export_torch.main(["--checkpoint", path, "--out", out] + ["--fold_weight_norm"] * fold) == [out]
        got = _loaded(out)
        assert sorted(got) == ["epochs", "model", "steps"] and (got["steps"], got["epochs"]) == (88, 0)
        tree = compat.efts_cnn_to_jax(model)
        _assert_same_state_dict(_as_numpy(got["model"]),
                                jexport.efts_cnn_to_state_dict(fold_weight_norm(tree) if fold else tree, jcfg))


def test_export_torch_generator_and_full_gan_state(vocoder_checkpoint, tmp_path):
    path, tree = vocoder_checkpoint
    jcfg = _jcfg(JHiFiGANConfig, VOC_CFG)
    for ema in (False, True):
        for fold in (False, True):
            out = str(tmp_path / f"generator_{ema}_{fold}")
            export_torch.main(["--model", "HiFiGANGenerator", "--checkpoint", path, "--out", out]
                              + ["--ema"] * ema + ["--fold_weight_norm"] * fold)
            got = _loaded(out)
            gen = tree["ema"] if ema else tree["gen"]["params"]
            assert sorted(got) == ["generator"]
            _assert_same_state_dict(_as_numpy(got["generator"]),
                                    jexport.hifigan_generator_to_state_dict(fold_weight_norm(gen) if fold else gen,
                                                                            jcfg))
    out = tmp_path / "full"
    paths = export_torch.main(["--model", "HiFiGANFull", "--checkpoint", path, "--out", str(out)])
    assert sorted(os.listdir(out)) == ["do_00000057", "g_00000057"] == sorted(os.path.basename(p) for p in paths)
    jg, jdo = jexport.gan_state_to_torch_checkpoints(tree, jcfg)
    g, do = _loaded(out / "g_00000057"), _loaded(out / "do_00000057")
    assert sorted(g) == ["generator"] and sorted(do) == ["epoch", "mpd", "msd", "steps"]
    assert (do["steps"], do["epoch"]) == (jdo["steps"], jdo["epoch"]) == (57, 0)
    _assert_same_state_dict(_as_numpy(g["generator"]), jg["generator"])
    _assert_same_state_dict(_as_numpy(do["mpd"]), jdo["mpd"])
    _assert_same_state_dict(_as_numpy(do["msd"]), jdo["msd"])


def _files(directory) -> dict:
    return {name: open(os.path.join(directory, name), "rb").read() for name in sorted(os.listdir(directory))}


@pytest.fixture()
def filelist(tmp_path):
    lines = [f"wavs/utt{i:02d}.wav|sentence number {i}." for i in (5, 3, 9, 1, 7, 2, 8, 4, 6)]
    lines.insert(4, "wavs/utt03.wav|a duplicate path.")
    path = tmp_path / "all.txt"
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


@pytest.mark.parametrize("args", [
    ["split", "{src}", "{out}/a.txt", "{out}/b.txt"],
    ["split", "{src}", "{out}/a.txt", "{out}/b.txt", "--num_first", "3", "--shuffle", "--seed", "7"],
    ["split", "{src}", "{out}/a.txt", "{out}/b.txt", "--num_second", "4"],
    ["combine", "{out}/all.txt", "{src}", "{src2}"],
    ["subset", "{src}", "4", "{out}/shards"],
], ids=["split_halves", "split_shuffled", "split_second", "combine", "subset"])
def test_data_utils_matches_jax(filelist, tmp_path, args):
    src2 = tmp_path / "more.txt"
    src2.write_text("wavs/utt00.wav|zero.\nwavs/utt05.wav|five again.\n")
    outs = {}
    for name, cli in (("port", data_utils), ("jax", jdata_utils)):
        out = tmp_path / name
        out.mkdir()
        argv = [a.format(src=filelist, src2=src2, out=out) for a in args]
        assert cli.main(argv) == 0
        outs[name] = _files(out) if args[0] != "subset" else _files(out / "shards")
    assert outs["port"] == outs["jax"] and outs["port"]


def test_prepare_databaker_matches_jax(tmp_path):
    root = tmp_path / "BZNSYP"
    (root / "ProsodyLabeling").mkdir(parents=True)
    (root / "ProsodyLabeling" / "000001-010000.txt").write_text(
        "000001\t卡尔普#2陪外孙#1玩滑梯#4。\n\tka2 er2 pu3 pei2 wai4 sun1 wan2 hua2 ti1\n"
        "000002\t假语村言#2别再#1拥抱我#4。\n\tjia2 yu3 cun1 yan2 bie2 zai4 yong1 bao4 wo3\n",
        encoding="utf-8")
    for name, cli in (("port", prepare_databaker), ("jax", jprepare_databaker)):
        cli.main(["--db_root", str(root), "--outdir", str(tmp_path / name), "--dev", "1", "--test", "0"])
    port, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port == jax_files and sorted(port) == ["dev.txt", "phnset.txt", "test.txt", "train.txt"]
    assert "k a2 er2 p u3" in port["dev.txt"].decode()
    assert list(prepare_databaker.parse_label_file(str(root / "ProsodyLabeling" / "000001-010000.txt"))) == \
        list(jprepare_databaker.parse_label_file(str(root / "ProsodyLabeling" / "000001-010000.txt")))


@pytest.fixture()
def wav_corpus(tmp_path):
    """Three short seeded PCM16 wavs at 22050 Hz and their filelist."""
    rng = np.random.default_rng(11)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    lines = []
    for i, seconds in enumerate((0.31, 0.47, 0.62)):
        n = int(seconds * 22050)
        t = np.arange(n) / 22050
        y = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(n)
        wavfile.write(wav_dir / f"u{i}.wav", 22050, (np.clip(y, -1, 1) * 32767).astype(np.int16))
        lines.append(f"elsewhere/u{i}.wav|utterance {i}.")
    path = tmp_path / "all.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), str(wav_dir)


def test_prepare_data_splits_match_jax(filelist, tmp_path):
    for name, cli in (("port", prepare_data), ("jax", jprepare_data)):
        cli.main(["--filelist", filelist, "--outdir", str(tmp_path / name), "--dev", "2", "--test", "3"])
    port = _files(tmp_path / "port")
    assert port == _files(tmp_path / "jax") and sorted(port) == ["dev.txt", "test.txt", "train.txt"]


def test_prepare_data_extract_mels_equals_the_dataset_cache(wav_corpus, tmp_path):
    scp, wav_dir = wav_corpus
    cache = tmp_path / "mels"
    prepare_data.main(["--filelist", scp, "--outdir", str(tmp_path / "data"), "--wav_path", wav_dir, "--dev", "0",
                       "--test", "1", "--extract_mels", "--mel_cache_dir", str(cache), "--num_workers", "2"])
    assert sorted(os.listdir(cache)) == ["u0.mel.npy", "u1.mel.npy", "u2.mel.npy"]
    ds = TextMelDataset(scp, wav_path=wav_dir)  # no cache: computes each mel itself
    jax_cache = tmp_path / "jax_mels"
    jax_cache.mkdir()
    for path, _ in ds.items:
        base = os.path.splitext(os.path.basename(path))[0]
        got = np.load(cache / f"{base}.mel.npy")
        want = ds.get_mel(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 80
        np.testing.assert_array_equal(got, want)
        jprepare_data._extract_one((path, wav_dir, str(jax_cache)))
        np.testing.assert_allclose(got, np.load(jax_cache / f"{base}.mel.npy"), rtol=0, atol=1e-3)


def _eval_batch(seed=0):
    rng = np.random.default_rng(seed)
    tl, ml = np.array([20, 13, 7], np.int32), np.array([64, 41, 22], np.int32)
    text = np.zeros((3, 20), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, CFG.num_symbols, n)
    mel = rng.standard_normal((3, 64, CFG.odim)).astype(np.float32)
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


def _record(monkeypatch, module, calls):
    for fn in ("save_imv_plot", "save_alignment_plot", "save_mel_comparison"):
        monkeypatch.setattr(module, fn, lambda *a, _fn=fn: calls.append((_fn, a)))


def test_plot_diagnostics_match_jax_trainer(work, tmp_path, monkeypatch):
    batch = _eval_batch()
    trainer = EftsTrainer(CFG, optimizer_from_dict({}), iter(()), eval_batches=[batch], outdir=str(tmp_path / "port"),
                          device="cpu")
    trainer.init_state(compat.efts_cnn_from_jax(work["tree"], CFG, device="cpu", trainable=True))
    port_calls, jax_calls = [], []
    _record(monkeypatch, plotting, port_calls)
    trainer.evaluate(6)
    _record(monkeypatch, jplotting, jax_calls)
    jcfg = _jcfg(je.EftsCNNConfig, CFG)
    out = jstep.make_eval_step(jcfg)(jax.tree_util.tree_map(jnp.asarray, work["tree"]),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    out = jax.device_get({k: out[k] for k in ("imv", "reconst_alpha", "mel_pred")})
    JEftsTrainer._plot_diagnostics(types.SimpleNamespace(outdir=str(tmp_path / "jax")), 6, out, batch)

    assert len(port_calls) == len(jax_calls) == 9
    for (fn, args), (jfn, jargs) in zip(port_calls, jax_calls):
        assert fn == jfn and len(args) == len(jargs)
        assert os.path.relpath(args[-1], tmp_path / "port") == os.path.relpath(jargs[-1], tmp_path / "jax")
        tol = 1e-4 if fn == "save_imv_plot" else 1e-5
        for a, ja in zip(args[:-1], jargs[:-1]):
            assert a.shape == np.asarray(ja).shape
            np.testing.assert_allclose(a, np.asarray(ja), rtol=tol, atol=tol)
    assert [os.path.basename(a[-1]) for _, a in port_calls[:3]] == ["step6_0_imv.png", "step6_0_align.png",
                                                                    "step6_0_mel.png"]

    # real images of the first utterance
    monkeypatch.undo()
    trainer._plot_diagnostics(6, {"imv": out["imv"][:1], "reconst_alpha": out["reconst_alpha"][:1],
                                  "mel_pred": out["mel_pred"][:1]}, batch)
    images = sorted(os.listdir(tmp_path / "port" / "images"))
    assert images == ["step6_0_align.png", "step6_0_imv.png", "step6_0_mel.png"]
    for name in images:
        assert (tmp_path / "port" / "images" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_diagnostics_without_matplotlib_warn_once(work, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(plotting, "available", lambda: False)
    trainer = EftsTrainer(CFG, optimizer_from_dict({}), iter(()), eval_batches=[_eval_batch()],
                          outdir=str(tmp_path), device="cpu")
    trainer.init_state(compat.efts_cnn_from_jax(work["tree"], CFG, device="cpu", trainable=True))
    with caplog.at_level("WARNING"):
        means = [trainer.evaluate(step) for step in (1, 2)]
    assert all(np.isfinite(v) for m in means for v in m.values())
    assert sum("matplotlib is not installed" in r.getMessage() for r in caplog.records) == 1
    assert not (tmp_path / "images").exists()


def test_profiling(tmp_path):
    x = torch.randn(64, 64)
    assert profiling.time_step(torch.matmul, x, x, iters=3, warmup=1, device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.time_step(torch.matmul, x, x)
    with profiling.trace(str(tmp_path / "trace")):
        torch.matmul(x, x)
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".json") and "aten::matmul" in (tmp_path / "trace" / name).read_text()
