"""Asynchronous checkpoint saves (`train/checkpoint.py`) and the trainers'
save policy, on the CPU, with small states.

Counterpart of JAX's orbax async checkpointer (`efficient_tts_tpu/train/
checkpoint.py:22-66`) and of its trainers' `save(wait=False)` at each
interval: a save copies the state to host memory before it returns and
writes in the background; at most one save is in flight; reads, pruning and
exit wait for it; a writer's error is raised at the next wait. The trainers
(`EftsTrainer`, `HiFiGANTrainer`, run with a stand-in step on a one-layer
state) save at each interval without waiting, and wait for the divergence
dump, the Ctrl-C save and pruning; `bin.train` waits for its final save.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from efficient_tts_tpu_torch.bench.corpus import make_corpus
from efficient_tts_tpu_torch.bin import train
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.train import checkpoint as ckpt
from efficient_tts_tpu_torch.train.efts_train_step import METRIC_KEYS
from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
from efficient_tts_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(step=3, seed=0):
    torch.manual_seed(seed)
    return {"params": torch.nn.Linear(8, 4), "opt_state": {"mu": {"weight": torch.randn(4, 8)},
                                                           "count": torch.tensor(step)}, "step": step}


def _weights(path):
    return ckpt.read_checkpoint(path)["params"]["weight"]


@pytest.fixture
def gated_writer(monkeypatch):
    """The writer held until the test opens its gate."""
    gate, real = threading.Event(), ckpt._write

    def held(path, snapshot):
        assert gate.wait(30), "the test never opened the writer's gate"
        real(path, snapshot)

    monkeypatch.setattr(ckpt, "_write", held)
    yield gate
    gate.set()
    ckpt.wait_for_saves()


def test_a_save_returns_before_a_slowed_writer_ends(tmp_path, gated_writer):
    path = ckpt.save_checkpoint(str(tmp_path), _state(), wait=False)
    assert not os.path.exists(path) and path == ckpt.checkpoint_path(str(tmp_path), 3)
    gated_writer.set()
    ckpt.wait_for_saves()
    assert os.path.exists(path) and os.listdir(tmp_path) == ["checkpoint-3steps"]


def test_an_update_in_place_after_a_save_does_not_reach_the_file(tmp_path, gated_writer):
    """The state dict shares storage with the live parameters and moments:
    the save copies them before it returns."""
    state = _state()
    before = state["params"].weight.detach().clone()
    mu = state["opt_state"]["mu"]["weight"].clone()
    path = ckpt.save_checkpoint(str(tmp_path), state, wait=False)
    with torch.no_grad():
        state["params"].weight.add_(1.0)
        state["opt_state"]["mu"]["weight"].mul_(0.0)
    gated_writer.set()
    saved = ckpt.read_checkpoint(path)
    assert torch.equal(saved["params"]["weight"], before)
    assert torch.equal(saved["opt_state"]["mu"]["weight"], mu)


def test_a_read_right_after_a_save_reads_the_whole_file(tmp_path, monkeypatch):
    real = ckpt._write

    def slow(path, snapshot):
        threading.Event().wait(0.3)
        real(path, snapshot)

    monkeypatch.setattr(ckpt, "_write", slow)
    state = _state()
    path = ckpt.save_checkpoint(str(tmp_path), state, wait=False)
    assert torch.equal(_weights(path), state["params"].weight.detach())
    assert ckpt.latest_checkpoint(str(tmp_path)) == path


def test_at_most_one_save_is_in_flight(tmp_path, gated_writer):
    """A second save waits for the first before it takes its snapshot."""
    ckpt.save_checkpoint(str(tmp_path), _state(step=1), wait=False)
    second = threading.Thread(target=ckpt.save_checkpoint, args=(str(tmp_path), _state(step=2)),
                              kwargs={"wait": False})
    second.start()
    second.join(0.3)
    assert second.is_alive() and not os.listdir(tmp_path)
    gated_writer.set()
    second.join(30)
    ckpt.wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1steps", "checkpoint-2steps"]


_EXIT = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from efficient_tts_tpu_torch.train import checkpoint as ckpt
real = ckpt._write
def slow(path, snapshot):
    time.sleep(1.0)
    real(path, snapshot)
ckpt._write = slow
state = {{"params": torch.nn.Linear(3, 2), "opt_state": {{}}, "step": 7}}
torch.save(state["params"].state_dict(), {want!r})
print(ckpt.save_checkpoint({outdir!r}, state, wait=False), flush=True)
"""


def test_the_exit_hook_flushes_a_pending_save(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    want = str(tmp_path / "want.pt")
    proc = subprocess.run([sys.executable, "-c", _EXIT.format(root=ROOT, want=want, outdir=str(tmp_path / "out"))],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert os.path.basename(path) == "checkpoint-7steps"
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 7
    for k, v in torch.load(want, weights_only=True).items():
        assert torch.equal(saved["params"][k], v)


def test_a_writers_error_is_raised_at_the_next_wait(tmp_path, monkeypatch):
    def broken(path, snapshot):
        raise OSError("no space left on device")

    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_checkpoint(str(tmp_path), _state(), wait=False)
    with pytest.raises(OSError, match="no space left"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # raised once, then the writer is idle
    # the next save, too, raises an earlier writer's error (and makes none
    # of its own), and so does a read
    ckpt.save_checkpoint(str(tmp_path), _state(), wait=False)
    with pytest.raises(OSError, match="no space left"):
        ckpt.save_checkpoint(str(tmp_path), _state(), wait=False)
    ckpt.save_checkpoint(str(tmp_path), _state(), wait=False)
    with pytest.raises(OSError, match="no space left"):
        ckpt.read_checkpoint(str(tmp_path / "checkpoint-3steps"))
    assert not os.listdir(tmp_path)


def test_the_files_equal_a_synchronous_saves(tmp_path):
    """Byte for byte, a module's state dict metadata and a moment tree included."""
    state = _state()
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), state)
    pending = ckpt.save_checkpoint(str(tmp_path / "async"), state, wait=False)
    ckpt.wait_for_saves()
    with open(sync, "rb") as a, open(pending, "rb") as b:
        assert a.read() == b.read()
    assert ckpt.read_checkpoint(sync)["params"]._metadata is not None


# the trainers' policy, on a stand-in step


def _recorded(monkeypatch):
    """[(file name, wait)] of every save the trainers make."""
    calls, real = [], ckpt.save_checkpoint

    def recording(outdir, state, name=None, wait=True):
        calls.append((os.path.basename(ckpt.checkpoint_path(outdir, state["step"], name)), wait))
        return real(outdir, state, name=name, wait=wait)

    monkeypatch.setattr(ckpt, "save_checkpoint", recording)
    return calls


def _losses(state, loss):
    """One update in place, as the optimizer makes it, and the step's metrics."""
    with torch.no_grad():
        state["params"].weight.add_(1.0)
    state["step"] += 1
    return state, torch.tensor(loss)


def _efts_trainer(tmp_path, losses, **kw):
    cfg = EftsCNNConfig(num_symbols=10, symbol_embedding_dim=8, n_channels=8, n_text_encoder_layer=1,
                        n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0)
    tx = optimizer_from_dict(load_config(os.path.join(ROOT, "efficient_tts_tpu_torch", "configs",
                                                      "lj_efts_cnn_char.yaml")))
    trainer = EftsTrainer(cfg, tx, ((0, loss) for loss in losses), outdir=str(tmp_path), log_interval_steps=1,
                          device="cpu", **kw)
    trainer.state = _state(step=0)

    def step(state, loss, gen=None):
        state, value = _losses(state, loss)
        return state, {k: value for k in METRIC_KEYS}

    trainer._train_step = step
    return trainer


def _gan_trainer(tmp_path, losses, **kw):
    def step(state, loss):
        state, value = _losses(state, loss)
        return state, {"g_loss": value, "d_loss": torch.tensor(1.0), "mel_l1": torch.tensor(0.5)}

    return HiFiGANTrainer(step, _state(step=0), ((0, loss) for loss in losses), outdir=str(tmp_path),
                          log_interval_steps=1, device="cpu", **kw)


TRAINERS = {"efts": _efts_trainer, "hifigan": _gan_trainer}


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_interval_saves_do_not_wait_and_pruning_does(kind, tmp_path, monkeypatch):
    calls = _recorded(monkeypatch)
    trainer = TRAINERS[kind](tmp_path, [1.0] * 4, train_max_steps=4, save_interval_steps=1,
                             max_keep_checkpoints=2)
    trainer.run()
    assert calls == [(f"checkpoint-{i}steps", False) for i in (1, 2, 3, 4)]
    # each prune waited for the write before it listed the directory
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-3steps", "checkpoint-4steps"]
    # the file holds the weights of its step, not the ones updated after it
    w0 = _state(step=0)["params"].weight.detach()
    assert torch.equal(_weights(str(tmp_path / "checkpoint-3steps")), w0 + 1.0 + 1.0 + 1.0)


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_the_divergence_dump_and_the_interrupt_save_wait(kind, tmp_path, monkeypatch):
    calls = _recorded(monkeypatch)
    trainer = TRAINERS[kind](tmp_path / "nan", [1.0, 1.0, float("nan"), 1.0, 1.0], train_max_steps=5,
                             save_interval_steps=2)
    with pytest.raises(FloatingPointError):
        trainer.run()
    # the interval save at step 2, then the dump of step 3 (read one step late)
    assert calls == [("checkpoint-2steps", False), ("diverged-state-3", True)]

    def interrupted():
        yield 0, 1.0
        raise KeyboardInterrupt

    calls.clear()
    trainer = TRAINERS[kind](tmp_path / "int", [], train_max_steps=5, save_interval_steps=100)
    trainer.train_iter = interrupted()
    with pytest.raises(KeyboardInterrupt):
        trainer.run()
    assert calls == [("checkpoint-1steps", True)]


def test_train_cli_waits_for_its_final_save(tmp_path, monkeypatch):
    """bin.train: the interval saves in the background, the final one waited
    for; the run's files are on disk when `main` returns."""
    corpus = make_corpus(str(tmp_path / "corpus"), n_train=3, n_dev=0, seed=4, min_s=0.4, max_s=0.6)
    config = load_config(os.path.join(ROOT, "efficient_tts_tpu_torch", "configs", "lj_efts_cnn_char.yaml"))
    config.update(model_name="EfficientTTSCNN", batch_size=3, train_max_steps=2, save_interval_steps=1,
                  log_interval_steps=1,
                  model_params=dict(num_symbols=148, symbol_embedding_dim=8, n_channels=8, n_text_encoder_layer=1,
                                    n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0))
    config["dataset_params"]["wav_path"] = corpus["wavs"]
    with open(tmp_path / "c.json", "w") as f:
        json.dump(config, f)
    calls = _recorded(monkeypatch)
    outdir = str(tmp_path / "exp")
    trainer = train.main(["--config", str(tmp_path / "c.json"), "--train_fid_scp", corpus["train"], "--outdir", outdir,
                          "--use_cpu"])
    assert calls == [("checkpoint-1steps", False), ("checkpoint-2steps", False), ("checkpoint-2steps", True)]
    saved = torch.load(os.path.join(outdir, "checkpoint-2steps"), weights_only=True)
    for k, v in trainer.state["params"].state_dict().items():
        np.testing.assert_array_equal(saved["params"][k].numpy(), v.numpy())
