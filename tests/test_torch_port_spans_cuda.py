"""A `device=True` span's CUDA events against the profiler's trace, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests in
`test_torch_port_spans.py` hold the host side). The span's device time,
between the CUDA events it records on the current stream at its ends,
brackets the kernels launched inside it: it equals their extent in the
trace (first start to last end) within 50 µs. Kernels queued before the
span keep the stream busy for about 3 ms, longer than entering the span
and launching its first kernel take under the profiler, so the first
event fires as the span's first kernel is about to start.
"""

import json

import pytest
import torch

from efficient_tts_tpu_torch.utils.profiling import span, spans

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_device_span_events_bracket_its_kernels(device, tmp_path):
    x = torch.randn(2048, 2048, device=device)
    for _ in range(3):  # this thread's cuBLAS handle and workspace, before the profiled stretch
        x @ x
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            x @ x
        with span("probe.device", device=True):
            for _ in range(6):
                x @ x
        torch.cuda.synchronize(device)
    (record,) = spans("probe.device")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (annotation,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "probe.device"]
    # cuBLAS launches through the driver API (`cuLaunchKernelEx`), PyTorch's own kernels through the runtime
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["tid"] == annotation["tid"]
                and "correlation" in e.get("args", {}) and annotation["ts"] <= e["ts"] <= annotation["ts"] + annotation["dur"]}
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched]
    assert len(kernels) >= 6
    extent_us = max(k["ts"] + k["dur"] for k in kernels) - min(k["ts"] for k in kernels)
    assert record.device_ms * 1e3 == pytest.approx(extent_us, abs=50.0)
