"""Cells, configurations, traffic and metrics found by name; the result line's shape; no JAX anywhere."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run, spec

PACKAGE = spec.PACKAGE
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_every_cell_resolves_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["model_name"] in ("EfficientTTSCNN", "EfficientTTSTransformer")
        assert spec.driver(cell).Session
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert set(cell.limits["limits"])


def test_benchmark_file_keeps_its_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"] and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("port_bench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
        assert not (m["name"].endswith("_roofline") or "mfu" in m["name"]) or m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_traffic_mix_is_a_data_file(tmp_path):
    """A copy of the benchmark with one more traffic file and one more cell runs
    that cell, its driver found through the file alone."""
    root = tmp_path / "checkout"
    shutil.copytree(PACKAGE, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    mix = json.loads((PACKAGE / "traffic" / "synth_b16.json").read_text())
    mix.update(batch=8, batches=3, why="batches of 8")
    (root / "port_bench" / "traffic" / "synth_b8.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "cnn_synth_b8", "config": "lj_efts_cnn_char_hifigan_v1",
                               "traffic": "synth_b8", "chips": 1, "why": "batches of 8"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cnn_synth_b16" in m.get("workloads", []):
            m["workloads"].append("cnn_synth_b8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("cnn_synth_b8", root=root, package=root / "port_bench")
    assert cell.traffic["batch"] == 8 and cell.traffic["driver"] == "synth"
    assert {m["name"] for m in cell.end_to_end} == {"synth_audio_s_per_s", "setup_s"}
    assert "k3_roofline" in {m["name"] for m in cell.per_layer}
    assert spec.driver(cell).__name__ == "port_bench.drivers.synth"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_result_line_format():
    result = {"correct": True, "attempted": 4, "failed": 0,
              "metrics": {"train_step_ms": {"value": 321.5, "unit": "ms"}, "setup_s": {"value": 17.5, "unit": "s"}},
              "check": {"loss_gap": {"value": 1e-7, "limit": 1e-6}}}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 6747021824}
    line = run.result_line(result, device, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert json.loads(json.dumps(line)) == line


def test_without_a_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cnn_synth_b16", "--seed", "3", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_modules(["efficient_tts_tpu_torch.pipeline", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["efficient_tts_tpu.models", "jax.numpy", "flax"]) == ["efficient_tts_tpu", "flax",
                                                                                         "jax"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        assert not (_imports(path) & set(run.FORBIDDEN)), path


def test_what_the_harness_loads_holds_no_jax():
    """Every module of the benchmark and the port's modules its drivers use, in a fresh interpreter."""
    code = ("import sys, importlib, pathlib\n"
            "from port_bench import run, spec, program\n"
            "from port_bench.drivers import synth, train, serve\n"
            "from port_bench.tools import calibrate, knee\n"
            "for p in pathlib.Path('port_bench/metrics').glob('*.py'): spec.metric_reader(p.stem)\n"
            "import efficient_tts_tpu_torch.pipeline, efficient_tts_tpu_torch.serve, efficient_tts_tpu_torch.compat\n"
            "import efficient_tts_tpu_torch.train.efts_train_step, efficient_tts_tpu_torch.train.optim\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
