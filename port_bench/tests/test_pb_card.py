"""The cells at their real sizes on the card, briefly (marker `cuda`; they skip without one).

    python -m pytest port_bench/tests/test_pb_card.py -q
"""

from __future__ import annotations

import time

import pytest

from port_bench import run, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("name", ["cnn_synth_b16", "tf_train_b64", "cnn_serve_poisson", "cnn_train_b128"])
def test_cell_is_correct_on_the_card(card, name):
    cell = spec.load_cell(name)
    cell.seed = 2**31 + 17
    result = run.execute(cell, 2.0, False, time.perf_counter())
    assert result["correct"], result["check"]
    assert result["memory_peak_bytes"] > 0
