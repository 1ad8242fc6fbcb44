"""The vocoder corpus held on the device (`data/device_corpus.py`) and its CLI path, on the CPU.

Three seeded wavs (a segment long, 3 segments and 123 samples, half a
segment; segment 2048, as `tests/test_device_corpus.py`):
  * `load_corpus` equals JAX's `load_corpus` bit for bit and is zero past
    each length; `corpus_nbytes` equals the tensor's bytes for 16- and
    32-bit integer and 32-bit float wavs written by scipy (JAX's estimate
    assumes 16 bits and no padding);
  * `batch_from_positions` fed JAX's own crop positions (derived as JAX's
    `batch_fn` draws them) against JAX's batch at steps 0, 1 and 17, one
    JAX compile for the file: the audio bit-equal, both mels within 1e-5 of
    their largest magnitude (`test_torch_port_gan.py`'s mel tolerance);
  * a wav shorter than a segment crops to itself and zeros; the crops are a
    function of the step, in bounds;
  * the fused device step equals the plain GAN step on the same batch bit
    for bit (a narrow generator, the full discriminators, B=1);
  * `bin.train_vocoder`: `on` with `--fine_tuning` raises naming the GTA
    mels; `auto` takes the device path on this corpus, and the host path
    above the budget or when fine-tuning; 2 steps, then a resume to 3, see
    the crops of an uninterrupted 3-step run. The CLI runs use a stand-in
    GAN step that records its batch, so they test the wiring, not the GAN.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import write as wav_write

from efficient_tts_tpu.data import device_corpus as jdc
from efficient_tts_tpu_torch.bin import train_vocoder
from efficient_tts_tpu_torch.data import device_corpus as dc
from efficient_tts_tpu_torch.dsp.mel import MelConfig, mel_spectrogram_np
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.train import hifigan_train_step
from efficient_tts_tpu_torch.train.hifigan_train_step import init_gan_state, make_gan_train_step
from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

SEG = 2048
B = 8
SEED = 1234


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module (Tier-1 runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _signal(n, i, rng):
    t = np.arange(n) / 22050.0
    return 0.4 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(n)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_corpus")
    rng = np.random.default_rng(7)
    paths = []
    for i, n in enumerate([SEG, 3 * SEG + 123, SEG // 2]):  # exact, long, short
        p = root / f"w{i}.wav"
        wav_write(p, 22050, (np.clip(_signal(n, i, rng), -1, 1) * 32767).astype(np.int16))
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def jax_batch_fn():
    """JAX's batch function, compiled once for the file."""
    return jax.jit(jdc.make_device_batch_fn(B, segment_size=SEG, seed=SEED))


def _jax_positions(corpus, step):
    """JAX's crop positions of `step`, drawn as its `batch_fn` draws them."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    k_idx, k_off = jax.random.split(key)
    idx = jax.random.randint(k_idx, (B,), 0, corpus["wav"].shape[0])
    max_start = jnp.maximum(corpus["len"][idx] - SEG, 0)
    u = jax.random.uniform(k_off, (B,))
    start = jnp.minimum(jnp.floor(u * (max_start + 1).astype(jnp.float32)).astype(jnp.int32), max_start)
    return np.asarray(idx), np.asarray(start)


def test_load_corpus_matches_jax(wav_files):
    want = jdc.load_corpus(wav_files, segment_size=SEG)
    got = dc.load_corpus(wav_files, segment_size=SEG, device="cpu")
    assert got["wav"].dtype == torch.float32 and got["len"].dtype == torch.int32
    assert got["wav"].shape == want["wav"].shape == (3, 7168)
    np.testing.assert_array_equal(got["wav"].numpy(), want["wav"])
    np.testing.assert_array_equal(got["len"].numpy(), want["len"])
    for i, n in enumerate(got["len"].tolist()):
        assert (got["wav"][i, n:] == 0).all() and (got["wav"][i, :n] != 0).any()


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_corpus_nbytes_is_exact(tmp_path, dtype):
    rng = np.random.default_rng(8)
    paths = []
    for i, n in enumerate([5000, 9000, 700]):
        a = 0.5 * _signal(n, i, rng)
        pcm = a.astype(np.float32) if dtype == np.float32 else (a * np.iinfo(dtype).max).astype(dtype)
        paths.append(str(tmp_path / f"{i}.wav"))
        wav_write(paths[-1], 22050, pcm)
    for seg in (SEG, 16384):
        corpus = dc.load_corpus(paths, segment_size=seg, device="cpu")
        assert dc.corpus_nbytes(paths, seg) == corpus["wav"].nbytes == 3 * dc.padded_width(9000, seg) * 4
        assert corpus["len"].tolist() == [5000, 9000, 700]
    if dtype != np.int16:  # JAX's estimate reads 2 bytes a sample and ignores the padding
        assert jdc.corpus_nbytes(paths) != dc.corpus_nbytes(paths, SEG)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_batch_from_positions_matches_jax(wav_files, jax_batch_fn, step):
    jcorpus = jax.device_put(jdc.load_corpus(wav_files, segment_size=SEG))
    want = jax.device_get(jax_batch_fn(jcorpus, step))
    idx, start = (np.array(a) for a in _jax_positions(jcorpus, step))
    batcher = dc.make_device_batch_fn(B, segment_size=SEG, seed=SEED, device="cpu")
    got = batcher.batch_from_positions(dc.load_corpus(wav_files, segment_size=SEG, device="cpu"),
                                       torch.from_numpy(idx), torch.from_numpy(start))
    np.testing.assert_array_equal(got["audio"].numpy(), want["audio"])
    for key in ("mel", "mel_loss"):
        assert got[key].shape == want[key].shape == (B, 8, 80)
        assert np.abs(got[key].numpy() - want[key]).max() <= 1e-5 * np.abs(want[key]).max()
    assert not np.array_equal(got["mel"].numpy(), got["mel_loss"].numpy())  # full band for the loss
    same = dc.make_device_batch_fn(2, segment_size=SEG, fmax_loss=8000.0, device="cpu")
    out = same.batch_from_positions(dc.load_corpus(wav_files, segment_size=SEG, device="cpu"), idx[:2], start[:2])
    assert out["mel_loss"] is out["mel"]
    np.testing.assert_allclose(out["mel"][0].numpy(), mel_spectrogram_np(out["audio"][0].numpy(), MelConfig()).T,
                               rtol=1e-4, atol=2e-4)


def test_crops_are_a_function_of_the_step_and_in_bounds(wav_files):
    corpus = dc.load_corpus(wav_files, segment_size=SEG, device="cpu")
    batcher = dc.make_device_batch_fn(B, segment_size=SEG, device="cpu")
    lens = corpus["len"].long()
    seen = set()
    for step in range(6):
        idx, start = batcher.crop_positions(corpus["len"], step)
        again = batcher.crop_positions(corpus["len"], step)
        assert torch.equal(idx, again[0]) and torch.equal(start, again[1])
        assert ((start >= 0) & (start <= torch.clamp(lens[idx] - SEG, min=0))).all()
        seen.add((tuple(idx.tolist()), tuple(start.tolist())))
    assert len(seen) == 6
    a, b = batcher(corpus, 5), batcher(corpus, 5)
    assert torch.equal(a["audio"], b["audio"]) and torch.equal(a["mel"], b["mel"])
    # a wav shorter than a segment crops to the wav and zeros
    short = dc.load_corpus(wav_files[2:], segment_size=SEG, device="cpu")
    n = int(short["len"][0])
    out = dc.make_device_batch_fn(4, segment_size=SEG, device="cpu")(short, 3)
    for row in out["audio"]:
        assert torch.equal(row[:n], short["wav"][0, :n]) and (row[n:] == 0).all()
    with pytest.raises(ValueError, match="the corpus lies on meta"):
        batcher.crop_positions(corpus["len"].to("meta"), 0)


def test_fused_device_step_equals_the_plain_step():
    cfg = HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                        segment_size=SEG)
    tx = HiFiGANAdam()
    rng = np.random.default_rng(0)
    corpus = {"wav": torch.from_numpy((0.1 * rng.standard_normal((2, 4096))).astype(np.float32)),
              "len": torch.tensor([4096, 3000], dtype=torch.int32)}
    plain = make_gan_train_step(cfg, tx, tx, device="cpu")
    batcher = dc.make_device_batch_fn(1, segment_size=SEG, device="cpu")
    fused = dc.make_device_gan_train_step(plain, batcher)
    a = init_gan_state(0, cfg, tx, tx, device="cpu")
    b = copy.deepcopy(a)
    a, ma = fused(a, corpus)
    b, mb = plain(b, batcher(corpus, 0))
    assert a["step"] == b["step"] == 1 and fused.loss_mel_cfg == plain.loss_mel_cfg
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for side in ("gen", "disc"):
        for (n, p), (_, q) in zip(a[side]["params"].state_dict().items(), b[side]["params"].state_dict().items()):
            assert torch.equal(p, q), (side, n)


# ---------------------------------------------------------------------------
# the CLI's data path, with a stand-in GAN step that records its batches


@pytest.fixture
def recording_cli(wav_files, tmp_path, monkeypatch):
    """A wav list, a narrow config and a stand-in for the GAN state and step:
    the state is two tiny modules, the step records (step, audio) and counts."""
    scp = tmp_path / "wavs.scp"
    scp.write_text("".join(w + "\n" for w in wav_files))
    config = tmp_path / "voc.json"
    config.write_text(json.dumps({"vocoder_params": {"upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                                                     "resblock_dilation_sizes": [[1, 2]], "segment_size": SEG}}))
    seen = []

    def fake_state(seed, voc_cfg, gen_tx, disc_tx, ema_decay=None, device="cuda"):
        return {"gen": {"params": torch.nn.Linear(2, 2), "opt_state": {}},
                "disc": {"params": torch.nn.Linear(2, 2), "opt_state": {}}, "step": 0}

    def fake_make_step(voc_cfg, gen_tx, disc_tx, **kw):
        def step(state, batch):
            seen.append((state["step"], torch.as_tensor(np.asarray(batch["audio"])).clone()))
            state["step"] += 1
            return state, {k: torch.tensor(1.0) for k in ("g_loss", "d_loss", "mel_l1")}

        step.loss_mel_cfg = None
        return step

    monkeypatch.setattr(hifigan_train_step, "init_gan_state", fake_state)
    monkeypatch.setattr(hifigan_train_step, "make_gan_train_step", fake_make_step)

    def run(outdir, *extra):
        seen.clear()
        trainer = train_vocoder.main(["--use_cpu", "--wav_scp", str(scp), "--config", str(config), "--outdir",
                                      str(tmp_path / outdir), "--batch_size", "4", "--log_interval_steps", "1",
                                      *extra])
        return trainer, list(seen)

    return run, tmp_path


def test_cli_device_corpus_resume_continues_the_crops(recording_cli):
    run, _ = recording_cli
    whole, crops = run("whole", "--train_max_steps", "3", "--save_interval_steps", "100")
    assert whole.data_path == "device" and [s for s, _ in crops] == [0, 1, 2]
    first, part = run("split", "--train_max_steps", "2", "--save_interval_steps", "2", "--device_corpus", "on")
    second, rest = run("split", "--train_max_steps", "3", "--save_interval_steps", "100")
    assert first.data_path == second.data_path == "device" and second.state["step"] == 3
    assert [s for s, _ in part + rest] == [0, 1, 2]
    for (_, a), (_, b) in zip(part + rest, crops, strict=True):
        assert torch.equal(a, b)
    assert not torch.equal(crops[0][1], crops[1][1])
    # the logged data wait on the device path is the fetch of (0, corpus)
    assert all(r["data_wait_s"] < 0.05 for r in whole.step_times)


def test_cli_picks_the_data_path(recording_cli, monkeypatch):
    run, tmp_path = recording_cli
    gta = tmp_path / "gta"
    gta.mkdir()
    for w in open(tmp_path / "wavs.scp").read().split():
        from scipy.io import wavfile

        audio = wavfile.read(w)[1].astype(np.float32) / 32768.0
        np.save(gta / (os.path.splitext(os.path.basename(w))[0] + ".npy"), mel_spectrogram_np(audio, MelConfig()))
    with pytest.raises(ValueError, match="GTA mels"):
        run("ft_on", "--device_corpus", "on", "--fine_tuning", "--base_mels_path", str(gta))
    # the host path drops the last partial batch: 2 of the 3 wavs a step
    tuned, _ = run("ft_auto", "--train_max_steps", "1", "--batch_size", "2", "--fine_tuning", "--base_mels_path",
                   str(gta))
    assert tuned.data_path == "host"
    off, _ = run("off", "--train_max_steps", "1", "--batch_size", "2", "--device_corpus", "off")
    assert off.data_path == "host"
    monkeypatch.setattr(train_vocoder, "DEVICE_CORPUS_BUDGET", dc.corpus_nbytes(
        open(tmp_path / "wavs.scp").read().split(), SEG) - 1)
    over, batches = run("over", "--train_max_steps", "1", "--batch_size", "2")
    assert over.data_path == "host" and batches[0][1].shape == (2, SEG)
