"""The port's host DSP and text-mel data pipeline against the JAX package, on the CPU.

A few seeded synthetic utterances (`bench/corpus.py`, 0.4-1.2 s, PCM_16 at
22050 Hz) in `tmp_path`, with char filelists and a phone filelist over a
written phone set, go through both packages: the filterbank, window and
`mel_spectrogram_np` are the same numpy code and must agree exactly; the
native libraries are built from the same source with the same flags and
must agree exactly with each other, and with the numpy path within 1e-3
(their FFT sums in f32, -ffast-math; the JAX package's own tests allow
5e-3); dataset items, collated batches and the loaders' batch order for a
seed and an epoch must be equal. `device_prefetch` runs with
device="cpu"; its card path runs in `chip_smoke.py` phase 4m.
"""

import os
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from efficient_tts_tpu import native as jnative
from efficient_tts_tpu.data import collate as jcollate
from efficient_tts_tpu.data import dataset as jdataset
from efficient_tts_tpu.data import loader as jloader
from efficient_tts_tpu.dsp import filters as jfilters
from efficient_tts_tpu.dsp import mel as jmel
from efficient_tts_tpu_torch import native
from efficient_tts_tpu_torch.bench.corpus import make_corpus
from efficient_tts_tpu_torch.data import collate, dataset, loader
from efficient_tts_tpu_torch.dsp import filters, mel
from efficient_tts_tpu_torch.train.efts_train_step import BATCH_DTYPES, batch_to_device

PHONES = ["!", "HH", "AH0", "L", "OW1", "W", "ER1", "D", "sp"]
MEL_CONFIGS = {"hifigan": dict(), "full_band_40": dict(num_mels=40, fmax=None),
               "short_window": dict(win_size=800, hop_size=200)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    paths = make_corpus(root, n_train=7, n_dev=2, seed=3, min_s=0.4, max_s=1.2)
    rng = np.random.default_rng(0)
    names = [line.split("|")[0] for line in open(paths["train"])]
    paths["phnset"] = os.path.join(root, "phnset.txt")
    with open(paths["phnset"], "w") as f:
        f.write("\n".join(PHONES) + "\n")
    paths["phone_list"] = os.path.join(root, "phones.txt")
    with open(paths["phone_list"], "w") as f:
        f.writelines(f"/elsewhere/{os.path.basename(n)}|{' '.join(rng.choice(PHONES[1:], 5))}\n" for n in names)
    return paths


def _datasets(corpus, mode, **cache):
    """The port's dataset with the `cache` arguments, and the JAX package's
    without them (so it extracts every mel itself)."""
    if mode == "char":
        path, kw = corpus["train"], dict(wav_path=corpus["wavs"])
    else:
        path, kw = corpus["phone_list"], dict(wav_path=corpus["wavs"], use_phnseq=True, phnset_path=corpus["phnset"])
    return dataset.TextMelDataset(path, **kw, **cache), jdataset.TextMelDataset(path, **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", list(MEL_CONFIGS))
def test_filterbank_window_and_numpy_mel_equal_jax(name, corpus):
    kw = MEL_CONFIGS[name]
    cfg, jcfg = mel.MelConfig(**kw), jmel.MelConfig(**kw)
    np.testing.assert_array_equal(filters.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax),
                                  jfilters.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax))
    np.testing.assert_array_equal(filters.hann_window(cfg.win_size), jfilters.hann_window(cfg.win_size))
    freqs = np.linspace(0, 11025, 97)
    np.testing.assert_array_equal(filters.hz_to_mel(freqs), jfilters.hz_to_mel(freqs))
    np.testing.assert_array_equal(filters.mel_to_hz(filters.hz_to_mel(freqs)), jfilters.mel_to_hz(jfilters.hz_to_mel(freqs)))
    wav = wavfile.read(os.path.join(corpus["wavs"], os.listdir(corpus["wavs"])[0]))[1].astype(np.float32) / 32768.0
    batch = np.stack([wav[:9000], wav[1000:10000]])
    for y in (wav, batch):
        np.testing.assert_array_equal(mel.mel_spectrogram_np(y, cfg), jmel.mel_spectrogram_np(y, jcfg))
    for n in (0, 100, 767, 768, 9000, len(wav)):
        assert mel.num_frames(n, cfg) == jmel.num_frames(n, jcfg)
    for fmax in (None, 8000.0, 11025.0):
        assert mel.loss_mel_config(cfg, fmax).__dict__ == jmel.loss_mel_config(jcfg, fmax).__dict__


def test_native_library_matches_jax_native_and_numpy(corpus):
    """The same source and flags: decode and mel equal to the JAX package's
    library; the mel within 1e-3 of the numpy path; PCM16 decode equal to
    scipy's samples / 32768. Both packages agree on whether g++ built it."""
    assert native.available() == jnative.available()
    assert native.backend() == ("native" if jnative.available() else "numpy")
    from scipy.io.wavfile import read

    for name in sorted(os.listdir(corpus["wavs"]))[:3]:
        path = os.path.join(corpus["wavs"], name)
        sr, raw = read(path)
        y = raw.astype(np.float32) / 32768.0
        if not native.available():
            assert native.decode_wav(path) is None and native.mel_spectrogram(y) is None
            continue
        got, got_sr = native.decode_wav(path)
        want, want_sr = jnative.decode_wav(path)
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, y)
        for kw in MEL_CONFIGS.values():
            m = native.mel_spectrogram(y, mel.MelConfig(**kw))
            np.testing.assert_array_equal(m, jnative.mel_spectrogram(y, jmel.MelConfig(**kw)))
            np.testing.assert_allclose(m, mel.mel_spectrogram_np(y, mel.MelConfig(**kw)), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["char", "phone"])
def test_dataset_items_equal_jax(corpus, mode, tmp_path):
    """The shuffled order, every item (text ids and [T2, 80] mel), the
    length proxy, and the disk and memory caches, which hand back the same
    mel."""
    ds, jds = _datasets(corpus, mode, mel_cache_dir=str(tmp_path / "mels"), mel_memory_cache_mb=1)
    assert ds.items == jds.items and len(ds) == len(jds) == 7
    for i in range(len(ds)):
        (text, m), (jtext, jm) = ds[i], jds[i]
        assert text.dtype == jtext.dtype == np.int32
        np.testing.assert_array_equal(text, jtext)
        assert m.shape[1] == 80 and m.dtype == np.float32
        np.testing.assert_array_equal(m, jm)
        assert ds.approx_length(i) == jds.approx_length(i) > 0
        assert ds[i][1] is m  # the memory cache
    assert len(os.listdir(tmp_path / "mels")) == 7
    cold, _ = _datasets(corpus, mode, mel_cache_dir=str(tmp_path / "mels"))
    np.testing.assert_array_equal(cold[0][1], ds[0][1])  # read back from the disk cache
    if mode == "phone":
        with pytest.raises(ValueError, match="phnset_path"):
            dataset.TextMelDataset(corpus["phone_list"], use_phnseq=True)


def test_collate_equals_jax(corpus):
    ds, _ = _datasets(corpus, "char")
    items = [ds[i] for i in range(5)]
    for kw in (dict(), dict(text_bucket=128, mel_bucket=128), dict(fixed_text_len=64, fixed_mel_len=200),
               dict(sort=False)):
        _assert_batches_equal([collate.collate_text_mel(items, **kw)], [jcollate.collate_text_mel(items, **kw)])
    with pytest.raises(ValueError, match="fixed length"):
        collate.collate_text_mel(items, fixed_mel_len=8)


def test_loader_batch_order_equals_jax(corpus):
    """`data_loader` for seeds, epochs, shards, length bucketing and
    drop_last, and the first batches of `infinite_loader` across an epoch
    boundary, batch for batch equal to the JAX package's."""
    ds, jds = _datasets(corpus, "char", mel_memory_cache_mb=4)

    def both(fn_t, fn_j, **kw):
        got = list(fn_t(ds, 2, collate.collate_text_mel, **kw))
        want = list(fn_j(jds, 2, jcollate.collate_text_mel, **kw))
        _assert_batches_equal(got, want)
        return got

    for kw in (dict(seed=0, epoch=0), dict(seed=0, epoch=1), dict(seed=5, epoch=2, drop_last=False),
               dict(seed=1, shard_id=1, num_shards=2), dict(shuffle=False, drop_last=False)):
        assert both(loader.data_loader, jloader.data_loader, **kw)
        assert both(loader.data_loader, jloader.data_loader, length_fn=ds.approx_length, **kw)
    got = [next(it) for it in [loader.infinite_loader(ds, 3, collate.collate_text_mel, seed=4)] for _ in range(5)]
    want = [next(it) for it in [jloader.infinite_loader(jds, 3, jcollate.collate_text_mel, seed=4)] for _ in range(5)]
    assert [e for e, _ in got] == [e for e, _ in want] == [0, 0, 1, 1, 2]
    _assert_batches_equal([b for _, b in got], [b for _, b in want])


def test_whole_corpus_batch_repeats_by_identity_through_the_prefetchers(corpus):
    """A batch of the whole corpus is collated once and yielded as the same
    object every epoch, through `background_prefetch` too; `device_prefetch`
    hands it over as the same tensors each time, cast on the host to the
    train step's dtypes, which `batch_to_device` then takes without a copy."""
    ds, _ = _datasets(corpus, "char", mel_memory_cache_mb=4)
    src = loader.background_prefetch(loader.infinite_loader(ds, len(ds), collate.collate_text_mel))
    items = [next(src) for _ in range(3)]
    assert [e for e, _ in items] == [0, 1, 2] and items[0][1] is items[1][1] is items[2][1]
    placed = list(loader.device_prefetch(iter(items), size=2, device="cpu", dtypes=BATCH_DTYPES))
    assert [e for e, _ in placed] == [0, 1, 2]
    first = placed[0][1]
    assert all(b is first for _, b in placed)
    assert {k: t.dtype for k, t in first.items()} == BATCH_DTYPES
    np.testing.assert_array_equal(first["mel"].numpy(), items[0][1]["mel"])
    on_device = batch_to_device(first, torch.device("cpu"))
    assert all(on_device[k] is first[k] for k in BATCH_DTYPES)


def test_prefetchers_keep_order_pass_errors_and_stop_their_workers():
    """Order and identity through both prefetchers, a worker's exception
    raised in the consumer, and a consumer closed early lets the worker
    thread end instead of blocking on its full queue."""
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
    out = list(loader.device_prefetch(loader.background_prefetch(enumerate(batches)), size=2, device="cpu"))
    assert [int(b["x"][0]) for _, b in out] == list(range(5))
    assert out[0][1]["x"].dtype == torch.int32

    def failing():
        yield 0, batches[0]
        raise OSError("unreadable wav")

    it = loader.background_prefetch(failing())
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    before = threading.active_count()
    it = loader.background_prefetch(((i, b) for i in range(1000) for b in batches), size=1)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
