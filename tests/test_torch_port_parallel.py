"""The port's multi-rank synthesis and serving (`efficient_tts_tpu_torch/parallel/`)
against the JAX package's, on the CPU.

Ranks are spawned processes on gloo (`tests/_torch_parallel_worker.py`,
which imports neither JAX nor this conftest), joined through a file://
rendezvous in the test's directory. JAX's `synthesize_fixed_sharded` runs
here once per mode on the 8 virtual CPU devices, at
`tests/test_sharded_synthesis.py`'s configs, batch and T2=64, with the same
seeded weights (`efficient_tts_tpu_torch.init`, carried into the port by
`compat`). Every mode is held to JAX's tolerance (atol 2e-5, rtol 1e-4) with
equal wav lengths, and against the port's one-process `synthesize_fixed`:
on the CPU dp is bit-equal to it; tp's column slices sum the mel's convs in
another order (about 2e-7) and sp's windows the waveform's (about 2e-8),
while the mel under sp and the lengths everywhere stay bit-equal.
"""

import dataclasses
import io
import os
import re
import signal
import subprocess
import sys
import time
import types
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import yaml

import _torch_parallel_worker as W
from efficient_tts_tpu import pipeline as jpipe
from efficient_tts_tpu.models.efficient_tts import EftsCNNConfig as JEftsCNNConfig
from efficient_tts_tpu.models.efficient_tts_transformer import EftsTransformerConfig as JEftsTransformerConfig
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.parallel.mesh import fit_data_extent as jfit_data_extent, make_mesh as jmake_mesh
from efficient_tts_tpu.parallel.sharding import _leaf_spec
from efficient_tts_tpu_torch import compat, init, pipeline
from efficient_tts_tpu_torch.bin import serve as serve_cli
from efficient_tts_tpu_torch.compat.torch_export import hifigan_generator_to_state_dict
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.nn.layers import fold_weight_norm
from efficient_tts_tpu_torch.parallel import fit_data_extent, make_mesh, param_specs
from efficient_tts_tpu_torch.parallel.mesh import mesh_layout
from efficient_tts_tpu_torch.serve import TTSEngine
from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
TOL = dict(atol=2e-5, rtol=1e-4)
# the outputs each mode gives bit-equal to the one-process path on the CPU
BIT_EQUAL = {"dp": ("wav", "wav_lengths", "mel"), "tp": ("wav_lengths",), "sp": ("wav_lengths", "mel"),
             "dp+tp": ("wav_lengths",), "dp+sp": ("wav_lengths", "mel")}
WORLD_OF = {"dp": "world2", "tp": "world2", "sp": "world2", "dp+tp": "world4", "dp+sp": "world4"}


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait_all(procs, logs, timeout):
    """Wait for every rank; if one fails or the time runs out, kill the rest."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait(timeout=30)
    return [p.returncode for p in procs], [open(f).read()[-4000:] for f in logs]


def _spawn(task, world, tmp):
    logs = [str(tmp / f"{task}.rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, task, str(r), str(world), f"file://{tmp}/rdv",
                                           str(tmp)], cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT))
    rcs, out = _wait_all(procs, logs, timeout=240)
    assert rcs == [0] * world, out
    return [dict(np.load(tmp / f"{task}.rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once, in threads that wait for their ranks."""
    with ThreadPoolExecutor(2) as pool:
        yield {t: pool.submit(_spawn, t, n, tmp_path_factory.mktemp(t)) for t, n in (("world2", 2), ("world4", 4))}


@pytest.fixture(scope="module")
def ranks(worlds):
    """Each world's per-rank results."""
    return {t: f.result() for t, f in worlds.items()}


@pytest.fixture(scope="module")
def jax_modes(worlds):
    """JAX's synthesize_fixed_sharded of each mode on its mesh of the 8 CPU
    devices, computed while the worlds run."""
    ep, vp = W.trees()
    text, lengths = W.batch()
    jcfg = JEftsCNNConfig(**dataclasses.asdict(W.EFTS_CFG))
    vcfg = JHiFiGANConfig(**dataclasses.asdict(W.VOC_CFG))
    return {mode: [np.asarray(x) for x in jpipe.synthesize_fixed_sharded(
        ep, vp, text, lengths, jcfg, vcfg, W.T2, jmake_mesh(*shape), mode=mode)]
        for mode, shape in W.MODES.items()}


@pytest.mark.parametrize("mode", list(W.MODES))
def test_mode_matches_jax_sharded_synthesis(jax_modes, ranks, mode):
    wav, wl, mel = jax_modes[mode]
    for r in ranks[WORLD_OF[mode]]:
        np.testing.assert_array_equal(r[f"{mode}/wav_lengths"], wl)
        np.testing.assert_allclose(r[f"{mode}/mel"], mel, **TOL)
        np.testing.assert_allclose(r[f"{mode}/wav"], wav, **TOL)


@pytest.mark.parametrize("mode", list(W.MODES))
def test_mode_matches_one_process_synthesis(ranks, mode):
    for r in ranks[WORLD_OF[mode]]:
        for key in ("wav", "wav_lengths", "mel"):
            got, want = r[f"{mode}/{key}"], r[f"one/{key}"]
            if key in BIT_EQUAL[mode]:
                np.testing.assert_array_equal(got, want, err_msg=f"{mode} {key}")
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=f"{mode} {key}")


def test_transformer_tp_matches_jax_and_one_process(ranks):
    """The EFTS-Transformer's attention projections and feed-forward run
    column-parallel under tp; the attention itself runs whole after the gather."""
    tree = init.init_efts_transformer(2, W.TR_CFG)
    jcfg = JEftsTransformerConfig(**dataclasses.asdict(W.TR_CFG))
    vcfg = JHiFiGANConfig(**dataclasses.asdict(W.VOC_CFG))
    wav, wl, mel = (np.asarray(x) for x in jpipe.synthesize_fixed_sharded(
        tree, W.trees()[1], *W.batch(), jcfg, vcfg, W.T2, jmake_mesh(1, 2), mode="tp"))
    for r in ranks["world2"]:
        np.testing.assert_array_equal(r["transformer_tp/wav_lengths"], wl)
        np.testing.assert_array_equal(r["transformer_tp/wav_lengths"], r["transformer_one/wav_lengths"])
        for key, want in (("mel", mel), ("wav", wav)):
            np.testing.assert_allclose(r[f"transformer_tp/{key}"], want, **TOL)
            np.testing.assert_allclose(r[f"transformer_tp/{key}"], r[f"transformer_one/{key}"], **TOL)


@pytest.mark.parametrize("name", ["efts", "voc"])
def test_tp_shrinks_each_sharded_leaf_by_the_model_extent(ranks, name):
    for r in ranks["world2"]:
        whole, per_rank = r[f"tp_bytes/{name}"]
        assert whole > 0 and per_rank * 2 == whole


def _jax_path(port_name: str) -> str:
    """A port tensor's path in the JAX package's (folded) tree."""
    parts = port_name.split(".")
    if parts == ["text_embedding"]:
        return "text_embedding/table"
    if parts[-1] == "weight":
        parts[-1] = "w"
    elif parts[-1] == "bias" and not any("norm" in p for p in parts[:-1]):
        parts[-1] = "b"
    return "/".join(parts)


def _generator_stage_paths(cfg, i, leaf):
    nk = len(cfg.resblock_kernel_sizes)
    return [f"resblocks/{i * nk + b}/{part}/{j}/{leaf}" for b, dils in enumerate(cfg.resblock_dilation_sizes)
            for j in range(len(dils)) for part in ("convs1", "convs2")]


TR_CFG = EftsTransformerConfig(num_symbols=10, n_channels=16, n_heads=2, ff_hidden=32, n_text_encoder_layer=1,
                               n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0)


@pytest.mark.parametrize("name,extent", [("efts", 2), ("voc", 2), ("transformer", 2), ("efts", 8), ("voc", 8)])
def test_sharded_leaves_follow_jax_rule_by_name(name, extent):
    """`param_specs` on the port's modules shards the leaves, named as the
    bridge names them in the JAX tree, that JAX's `_leaf_spec` shards (on the
    tree the bridge folds: the rule reads shapes only)."""
    if name == "efts":
        tree = init.init_efts(0, W.EFTS_CFG)
        module = compat.efts_cnn_from_jax(tree, W.EFTS_CFG, device="cpu")
    elif name == "voc":
        tree = init.init_generator(1, W.VOC_CFG)
        module = compat.hifigan_generator_from_jax(tree, W.VOC_CFG, device="cpu")
    else:
        tree = init.init_efts_transformer(0, TR_CFG)
        module = compat.efts_transformer_from_jax(tree, TR_CFG, device="cpu")
    specs = param_specs(module, types.SimpleNamespace(shape={"data": 1, "model": extent}))
    port = {}
    for n, axis in specs.items():
        stage = re.fullmatch(r"stages\.(\d+)\.(weight|bias)", n)
        paths = (_generator_stage_paths(W.VOC_CFG, int(stage[1]), "w" if stage[2] == "weight" else "b")
                 if stage else [] if n.endswith("weight_bf16") else [_jax_path(n)])
        port.update({p: axis is not None for p in paths})
    jax_specs = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax_specs.__setitem__("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                                                 _leaf_spec(path, leaf, extent) != jax.sharding.PartitionSpec()),
        fold_weight_norm(tree))
    assert set(port) <= set(jax_specs)
    assert port == {p: jax_specs[p] for p in port}
    assert any(port.values()) and not all(port.values())


def test_unknown_mode_raises():
    model, voc = W.models()
    text, lengths = W.batch()
    with pytest.raises(ValueError, match="dp/tp/sp"):
        pipeline.synthesize_fixed_sharded(model, voc, text, lengths, W.T2, None, mode="batch", device="cpu")
    with pytest.raises(ValueError, match="dp/tp/sp"):
        pipeline.synthesize_fixed_sharded(model, voc, text, lengths, W.T2, None, mode="", device="cpu")


@pytest.mark.parametrize("n,data,model", [(8, None, 1), (8, None, 2), (8, 4, 2), (8, 2, 2), (8, 1, 8), (4, 2, 2),
                                          (2, 1, 2), (8, None, 3), (8, 4, 4), (6, None, 4)])
def test_mesh_layout_matches_jax(n, data, model):
    devices = jax.devices()[:n]
    try:
        want = np.vectorize(lambda d: d.id)(jmake_mesh(data, model, devices=devices).devices) - devices[0].id
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)).replace("devices", "ranks")):
            mesh_layout(n, data, model)
        return
    np.testing.assert_array_equal(mesh_layout(n, data, model), want)


def test_fit_data_extent_matches_jax():
    for b in range(1, 33):
        for n in range(1, 9):
            assert fit_data_extent(b, n) == jfit_data_extent(b, n)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(1, 1)


def test_meshes_in_a_world_of_four(ranks):
    # [data, model, member, data_index, model_index, has data group, has model group]
    want_1x2 = [[1, 2, 1, 0, 0, 1, 1], [1, 2, 1, 0, 1, 1, 1], [1, 2, 0, -1, -1, 0, 0], [1, 2, 0, -1, -1, 0, 0]]
    want_auto = [[2, 2, 1, i // 2, i % 2, 1, 1] for i in range(4)]
    for r, a, b in zip(ranks["world4"], want_1x2, want_auto):
        np.testing.assert_array_equal(r["mesh_1x2"], a)
        np.testing.assert_array_equal(r["mesh_auto"], b)


def test_ragged_dp_synthesize_takes_the_one_card_bucket(ranks):
    model, voc = W.models(ragged=True)
    text, lengths = W.ragged_batch()
    mel_lengths = pipeline.predict_lengths(model, text, lengths, device="cpu").numpy()
    halves = [pipeline.bucket_length(int(mel_lengths[h].max()), 64) for h in (slice(0, 4), slice(4, 8))]
    assert halves[0] != halves[1], f"the halves' buckets are equal: {halves}"
    for r in ranks["world2"]:
        assert r["ragged/wav"].shape[1] == max(halves) * W.VOC_CFG.hop_size
        np.testing.assert_array_equal(r["ragged/wav_lengths"], r["ragged/one_wav_lengths"])
        np.testing.assert_array_equal(r["ragged/wav"], r["ragged/one_wav"])


def test_engine_over_two_ranks_matches_the_one_process_engine(ranks):
    wants = TTSEngine(*W.serve_models(), device="cpu", max_batch=8).synthesize(W.TEXTS)
    for r in ranks["world2"]:
        for i, want in enumerate(wants):
            got = r[f"engine/{i}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _plain(cfg) -> dict:
    return yaml.safe_load(yaml.safe_dump(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def served_checkpoints(tmp_path_factory):
    """A port checkpoint of the serving EFTS-CNN and a reference generator
    file, each with its config.yml."""
    root = tmp_path_factory.mktemp("served")
    model, _ = W.serve_models()
    ckpt = save_checkpoint(str(root / "efts"), {"params": model, "opt_state": None, "step": 1})
    with open(root / "efts" / "config.yml", "w") as f:
        yaml.safe_dump({"model_name": "EfficientTTSCNN", "model_params": _plain(W.SERVE_EFTS_CFG)}, f)
    gen = compat.generator_from_jax(init.init_generator(1, W.SERVE_VOC_CFG), W.SERVE_VOC_CFG, device="cpu")
    (root / "voc").mkdir()
    voc = str(root / "voc" / "generator.pt")
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in hifigan_generator_to_state_dict(gen).items()}}, voc)
    with open(root / "voc" / "config.yml", "w") as f:
        yaml.safe_dump({"vocoder_params": _plain(W.SERVE_VOC_CFG)}, f)
    return ["--checkpoint", ckpt, "--vocoder_checkpoint", voc, "--use_cpu", "--max_batch", "2"]


def _post(port, text):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=f'{{"text": "{text}"}}'.encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        with wave.open(io.BytesIO(resp.read())) as w:
            return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_serve_data_parallel_over_two_ranks(served_checkpoints, tmp_path):
    """`bin.serve --data_parallel 2`: rank 0 answers HTTP, rank 1 follows;
    SIGTERM to rank 0 stops both, each exiting 0."""
    args = served_checkpoints + ["--data_parallel", "2", "--no_warmup", "--host", "127.0.0.1", "--port", "0",
                                 "--coordinator_address", f"file://{tmp_path}/rdv", "--num_processes", "2"]
    logs = [str(tmp_path / f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-m", "efficient_tts_tpu_torch.bin.serve", *args,
                                           "--process_id", str(r)], cwd=REPO, env=_env(), stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        deadline, port = time.monotonic() + 120, None
        while port is None and time.monotonic() < deadline and all(p.poll() is None for p in procs):
            m = re.search(r"serving on 127\.0\.0\.1:(\d+)", open(logs[0]).read())
            port = int(m[1]) if m else time.sleep(0.1)
        assert port is not None, [open(f).read()[-3000:] for f in logs]
        got = [_post(port, t) for t in W.TEXTS]
        procs[0].send_signal(signal.SIGTERM)
        rcs, out = _wait_all(procs, logs, timeout=60)
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0], out
    assert "following" in out[1]
    engine = serve_cli.build_engine(serve_cli.get_parser().parse_args(served_checkpoints))
    for pcm, want in zip(got, engine.synthesize(W.TEXTS)):
        want = np.round(np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16)
        assert pcm.shape == want.shape
        assert np.abs(pcm.astype(np.int32) - want).max() <= 1


def test_serve_data_parallel_needs_its_world(served_checkpoints):
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        serve_cli.main(served_checkpoints + ["--data_parallel", "2"])
    with pytest.raises(SystemExit, match="not divisible"):
        serve_cli.main(served_checkpoints + ["--data_parallel", "3"])
