"""The plain reference against the port's plain paths, the control and planted faults, at a size the CPU holds.

Each run here is the harness's own (`run.execute`) on a narrowed cell on the
CPU: set-up, a short window, the check. Sound runs come out correct; the
control (the reference in TF32, emulated on the CPU, put in the program's
place) and each fault the cell can have, planted in the timed path, come out
not correct under the cells' own limits.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from port_bench import program, run, spec
from port_bench.reference import efts as ref_efts
from port_bench.reference import hifigan as ref_hifigan
from port_bench.reference.ops import Ops
from port_bench.reference.text import encode
from port_bench.tests.tiny import tiny_cell

CELLS = ("cnn_synth_b16", "cnn_train_b128", "tf_train_b64", "cnn_serve_poisson")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _execute(cell, seconds=0.5):
    return run.execute(cell, seconds, False, time.perf_counter())


def test_reference_synthesis_matches_the_port_plain_path():
    from efficient_tts_tpu_torch import pipeline

    cell = tiny_cell("cnn_synth_b16")
    trees = program.inference_trees(cell.config, 11, "cpu")
    model, voc = program.inference_models(cell.config, trees, "cpu")
    texts = ["Of the witness.", "A.", "The prisoner said that money was in the house."]
    ids = [encode(t) for t in texts]
    lengths = np.array([len(i) for i in ids])
    text = np.zeros((3, lengths.max()), np.int64)
    for j, i in enumerate(ids):
        text[j, :len(i)] = i
    t2 = 320
    wav, wav_lengths, mel = pipeline.synthesize_fixed(model, voc, text, lengths, t2, mrf_impl="plain", device="cpu")
    mp, vp = cell.config["model_params"], cell.config["vocoder_params"]
    ops = Ops()
    with torch.no_grad():
        s1 = ref_efts.cnn_stage1(trees[0], mp, torch.from_numpy(text), torch.from_numpy(lengths), ops)
        ref_mel, ref_lengths = ref_efts.cnn_decode(trees[0], mp, s1, [0, 1, 2], t2, ops)
        ref_wav = ref_hifigan.generator(trees[1], vp, ref_mel, ops)
    hop = vp["hop_size"]
    assert torch.equal(wav_lengths.long(), ref_lengths * hop)
    assert torch.allclose(mel, ref_mel, rtol=1e-5, atol=1e-5)
    for j in range(3):
        n = int(ref_lengths[j]) * hop
        assert torch.allclose(wav[j, :n], ref_wav[j, :n], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _execute(tiny_cell(name))
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    limits = spec.load_cell(name).limits["limits"]
    # well inside the limits, not just under them
    for k, c in result["check"].items():
        assert c["value"] <= limits[k] / 3, (k, c)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference computed in TF32 in the program's place fails a number."""
    cell = tiny_cell(name)
    session = spec.driver(cell).Session(cell)
    session.window(0.5)
    session.release()
    session.substitute(Ops(tf32=True))
    numbers = session.check(Ops())
    limits = cell.limits["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def _alter_where_produced(monkeypatch, rows=None):
    """Break the pipeline's stage 2: one sample of every waveform altered, or
    (`rows="half"`) the second half of the batch left out (zeros)."""
    from efficient_tts_tpu_torch import pipeline

    real = pipeline._decode_and_vocode

    def broken(*args, **kwargs):
        wav, wav_lengths, mel = real(*args, **kwargs)
        wav = wav.clone()
        if rows == "half":
            wav[wav.shape[0] // 2:] = 0
        elif wav.dtype == torch.int16:
            wav[:, 5] = wav[:, 5] + 2000
        else:
            wav[:, 5] = wav[:, 5] + 0.05
        return wav, wav_lengths, mel

    monkeypatch.setattr(pipeline, "_decode_and_vocode", broken)


@pytest.mark.parametrize("name", ["cnn_synth_b16", "cnn_serve_poisson"])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    _alter_where_produced(monkeypatch)
    assert not _execute(tiny_cell(name))["correct"]


def test_half_a_synthesis_batch_left_out_is_not_correct(monkeypatch):
    _alter_where_produced(monkeypatch, rows="half")
    assert not _execute(tiny_cell("cnn_synth_b16"))["correct"]


def _break_train_step(monkeypatch, fault):
    from efficient_tts_tpu_torch.train import efts_train_step

    real = efts_train_step.make_train_step

    def make(cfg, tx, *args, **kwargs):
        step = real(cfg, tx, *args, **kwargs)

        def broken(state, batch, gen=None):
            if fault == "unchanged":
                _, metrics = step(copy.deepcopy(state), batch, gen)
                return state, metrics
            half = batch["text"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()}, gen)

        return broken

    monkeypatch.setattr(efts_train_step, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["cnn_train_b128", "tf_train_b64"])
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    _break_train_step(monkeypatch, fault)
    assert not _execute(tiny_cell(name))["correct"]
