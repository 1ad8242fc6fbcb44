"""The port under several threads, as the serving engine drives it: the
process-wide TF32 flags of `utils/precision.py:full_f32`, the kernels'
first-use build (`_build.load`), the MRF stages' kernel-weight cache and the
kernels' launch counters. All on the CPU: the build runs a stand-in for nvcc
that copies a shared library."""

import ctypes
import os
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from efficient_tts_tpu_torch import _build
from efficient_tts_tpu_torch.models import hifigan
from efficient_tts_tpu_torch.ops import flash_attention, launch_counts, mrf
from efficient_tts_tpu_torch.utils import precision


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_full_f32_keeps_flags_off_until_the_last_thread_leaves():
    """A enters, B enters, A leaves, B leaves: both see the flags off until B
    leaves (A's exit must not restore them under B), and the values from
    before A's entry come back after."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {"a": [], "b": []}

    def thread_a():
        with precision.full_f32():
            seen["a"].append(_flags())
            a_in.set()
            b_in.wait(10)
            seen["a"].append(_flags())
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with precision.full_f32():
            seen["b"].append(_flags())
            b_in.set()
            a_out.wait(10)
            seen["b"].append(_flags())  # A has left; B is still inside

    try:
        threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        assert seen["a"] == [(False, False)] * 2
        assert seen["b"] == [(False, False)] * 2
        assert _flags() == (True, True)
        # nested entries in one thread count as well
        with precision.full_f32():
            with precision.full_f32():
                pass
            assert _flags() == (False, False)
        assert _flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


_FAKE_NVCC = """#!{python}
import shutil, sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(args[args.index("-o") + 1] + "\\n")
time.sleep(0.5)  # long enough for a second thread to arrive
shutil.copyfile({lib!r}, args[args.index("-o") + 1])
"""


def test_build_raced_from_two_threads_builds_once(tmp_path, monkeypatch):
    """Two threads reach a kernel's first use together: one nvcc runs, both
    get the same library. The stand-in for nvcc logs each call and copies a
    shared library (ctypes' own extension) to the output."""
    import _ctypes

    src, out, log = tmp_path / "csrc", tmp_path / "_build", tmp_path / "nvcc.log"
    src.mkdir()
    (src / "fake.cu").write_text("// stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log), lib=_ctypes.__file__))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})

    barrier = threading.Barrier(2)
    libs, errors = [], []

    def use():
        try:
            barrier.wait(10)
            libs.append(_build.load("fake"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    # the temporary output is named by the process and the thread that built it
    assert calls[0].endswith(tuple(f".tmp{os.getpid()}.{t.ident}" for t in threads)), calls
    assert len(libs) == 2 and libs[0] is libs[1] and isinstance(libs[0], ctypes.CDLL)
    built = [p.name for p in out.iterdir()]
    assert len(built) == 1 and built[0].startswith("fake.") and built[0].endswith(".so"), built
    # a second load reuses the library; a cold process would reuse the file
    assert _build.load("fake") is libs[0]
    assert len(log.read_text().splitlines()) == 1


def test_mrf_stage_kernel_weights_made_once_under_threads(monkeypatch):
    """8 threads ask one stage for its kernel weights at once: they are made
    once and every thread gets the same object."""
    cfg = hifigan.HiFiGANConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                                resblock_dilation_sizes=((1, 2),))
    stage = hifigan.MRFStage(32, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    made = []
    real = hifigan.kernel_weights

    def slow_kernel_weights(ws, biases=None):
        made.append(1)
        time.sleep(0.2)
        return real(ws, biases)

    monkeypatch.setattr(hifigan, "kernel_weights", slow_kernel_weights)
    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait(10)
        got.append(stage.kernel_weights(torch.float32))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 1 and len(got) == 8 and all(kw is got[0] for kw in got)
    # a change of the weights still makes them again
    stage.load([np.ones((k, 32, 32), np.float32) for k, _, _ in stage.shapes],
               np.zeros((len(stage.shapes), 32), np.float32))
    assert stage.kernel_weights(torch.float32) is not got[0] and len(made) == 2


@pytest.mark.parametrize("module", [mrf, flash_attention])
def test_launch_counters_count_every_launch_under_threads(module):
    """8 threads add to a kernel module's launch counter at once, with the
    interpreter switching threads as often as it can: no launch is lost."""
    module.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        barrier = threading.Barrier(8)

        def bump():
            barrier.wait(10)
            for _ in range(20000):
                launch_counts.add(module.launches, ("bf16", 32))

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert module.launches == {("bf16", 32): 8 * 20000}
    module.reset_launches()

