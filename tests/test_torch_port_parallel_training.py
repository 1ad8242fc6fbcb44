"""The port's training over ranks (`parallel/`, `train/`, the training CLIs)
against the JAX package's sharded steps and the port's one-process step, on
the CPU; and the last modules, `nn/init.py` and `version.py`.

Ranks are spawned processes on gloo (`tests/_torch_parallel_training_worker.py`,
which imports neither JAX nor this conftest), joined through a file://
rendezvous: one launch of 2 ranks, one of 4, and the one-process references
in a third process, all at once, while JAX's sharded steps run on the
virtual CPU devices in four processes of their own. Sizes: EFTS-CNN and the EFTS-Transformer with 64
channels and 2-layer towers on a batch of 8 (T1 = 24, T2 = 64) whose rows are
short on data row 0 and long on row 1, under the char yaml's optimizer with
a 4-step warmup; the GAN with the narrow generator of `test_torch_port_gan.py`
(the full MPD and MSD), B = 2, segment 1024, HiFi-GAN's Adam.

Tolerances, f32 everywhere:
  * against JAX's step on the same global batch (`make_train_step(mesh=)`
    after `shard_state`; the GAN's after `shard_gan_state` on a (1, 2) mesh,
    which both port meshes are held to, see `_jax_gan`): metrics rtol 1e-4; the parameter
    updates rtol 1e-3 where the one-process port's first moment is above
    1e-3 of its leaf's max (`test_torch_port_cnn_training.py:
    test_train_step_matches_jax`'s rule);
  * against the port's one-process step: metrics rtol 1e-5, the updates
    rtol 1e-4 on the same entries, and the first moments (the clipped,
    decayed gradients) within 1e-4 of each leaf's max plus 1e-7 of the
    tree's; the GAN's discriminator moments within 1e-4 of the leaf's max
    plus 1e-6 of the discriminators' largest, and the generator's within
    1e-3 of the leaf's plus 2e-4 of the generator's largest: its gradient
    reaches the waveform through sums with heavy cancellation
    (`test_torch_port_gan.py`), and a block of one row sums in another order
    than the batch of two (measured: 1.0e-4 of the largest, 3.1e-3 of a
    weight-norm g leaf's own max); the discriminators' parameters are held
    to one process within 1e-4 of each leaf's max, and their updates to
    JAX's where the first moment is above 1e-3 of its leaf's max. The
    generator's parameters and updates are not: Adam's first step is
    lr * g / (|g| + eps), a sign, which turns the generator's noise floor
    into whole flips of 2 lr (up to 0.9% of a leaf of N(0, 0.01) weights,
    seen against one process and against JAX alike); its moments are held
    instead;
  * the tp gradients against the whole model's slices: 1e-5 of each leaf's
    max plus 1e-7 of the model's largest; every rank's gathered state
    bit-equal to every other's.
The updates are held as `_assert_trees_close` holds leaves, on the sure
entries only.
"""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_training_worker as W
from efficient_tts_tpu.models import efficient_tts as je
from efficient_tts_tpu.models import efficient_tts_transformer as jtr
from efficient_tts_tpu.models import hifigan as jhg
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.nn import init as jinit
from efficient_tts_tpu.parallel.mesh import make_mesh as jmake_mesh
from efficient_tts_tpu.train import efts_train_step as jstep
from efficient_tts_tpu.train import hifigan_train_step as jgan
from efficient_tts_tpu.train.optim import hifigan_adam
from efficient_tts_tpu.utils.config import optimizer_from_dict as joptimizer_from_dict
from efficient_tts_tpu_torch import __version__, compat, init
from efficient_tts_tpu_torch.bench.corpus import make_corpus
from efficient_tts_tpu_torch.bin import train_vocoder
from efficient_tts_tpu_torch.data.loader import device_prefetch
from efficient_tts_tpu_torch.nn import init as tinit
from efficient_tts_tpu_torch.parallel import split_batch
from efficient_tts_tpu_torch.train import checkpoint as ckpt
from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
from efficient_tts_tpu_torch.utils import plotting
from efficient_tts_tpu_torch.version import __version__ as module_version

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_training_worker.py")
JAX_RTOL, ONE_RTOL = 1e-4, 1e-5
CNN_MODES = {"dp": "world2", "tp": "world2", "sp": "world2", "dp+tp": "world4"}
TR_MODES = {"dp": "world2", "tp": "world2", "sp": "world2", "dp+sp": "world4"}
GAN_MODES = {"dp": "world2", "dp+tp": "world4"}
VOC_KW = dict(upsample_initial_channel=64, resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
              segment_size=1024)


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(task, world, tmp):
    logs = [str(tmp / f"{task}.rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, task, str(r), str(world), f"file://{tmp}/rdv",
                                           str(tmp)], cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + 400
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * world, [open(f).read()[-4000:] for f in logs]
    return [dict(np.load(tmp / f"{task}.rank{r}.npz")) for r in range(world)]


def _paths(tmp):
    """A seeded corpus (6 train, 2 dev utterances), a tiny EFTS-CNN config
    (batch 4, 2 steps) and a narrow vocoder config, shared by every task."""
    corpus = make_corpus(str(tmp / "corpus"), n_train=6, n_dev=2, seed=1, min_s=0.4, max_s=1.0)
    config = W.optimizer_config()
    config.update(model_name="EfficientTTSCNN", batch_size=4, train_max_steps=2, save_interval_steps=2,
                  eval_interval_steps=2, log_interval_steps=1,
                  model_params=dict(num_symbols=148, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=1,
                                    n_mel_encoder_layer=1, n_decoder_layer=1, dropout_rate=0.0, use_masking=True))
    config["dataset_params"]["wav_path"] = corpus["wavs"]
    paths = {"train": corpus["train"], "dev": corpus["dev"], "cnn": str(tmp / "cnn.json"), "voc": str(tmp / "voc.json"),
             "wav_scp": str(tmp / "wav.scp")}
    with open(paths["cnn"], "w") as f:
        json.dump(config, f)
    with open(paths["voc"], "w") as f:
        json.dump({"vocoder_params": VOC_KW}, f)
    with open(corpus["train"]) as f, open(paths["wav_scp"], "w") as g:
        g.writelines(os.path.join(str(tmp / "corpus"), line.split("|")[0]) + "\n" for line in f)
    for key in ("train_out", "voc_out", "one_train_out", "one_voc_out"):
        paths[key] = str(tmp / key)
    with open(tmp / "paths.json", "w") as f:
        json.dump(paths, f)
    return paths


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The two worlds and the one-process references, started at once."""
    tmp = {t: tmp_path_factory.mktemp(t) for t in ("world2", "world4", "one")}
    paths = _paths(tmp["world2"])
    for t in ("world4", "one"):
        with open(tmp[t] / "paths.json", "w") as f:
            json.dump(paths, f)
    with ThreadPoolExecutor(3) as pool:
        yield {"paths": paths, "tmp": tmp,
               **{t: pool.submit(_spawn, t, n, tmp[t]) for t, n in (("world2", 2), ("world4", 4), ("one", 1))}}


@pytest.fixture(scope="module")
def ranks(launches, jax_steps):
    return {t: launches[t].result() for t in ("world2", "world4", "one")}


def _jcfg(cfg):
    cls = je.EftsCNNConfig if isinstance(cfg, W.EftsCNNConfig) else jtr.EftsTransformerConfig
    return cls(**dataclasses.asdict(cfg))


def _jax_acoustic(cfg, shape, sp=False, accum=1):
    params = W.tree(cfg)
    mesh = jmake_mesh(*shape)
    tx = joptimizer_from_dict(W.optimizer_config())
    state = jstep.shard_state(params, tx, mesh)
    step = jstep.make_train_step(_jcfg(cfg), tx, mesh=mesh, sequence_parallel=sp, accum_steps=accum)
    state, m = step(state, jstep.shard_batch({k: jnp.asarray(v) for k, v in W.batch().items()}, mesh),
                    jax.random.PRNGKey(0))
    return (np.array([float(m[k]) for k in W.METRICS]), W.flat(jax.tree_util.tree_map(np.asarray, params)),
            W.flat(jax.tree_util.tree_map(np.asarray, state["params"])))


def _jax_gan():
    """JAX's GAN step from `shard_gan_state` on a (1, 2) mesh (the generator
    split over 'model'), its initializers handing it the port's seeded
    leaves (its own draws take half a minute). On a (2, 2) mesh of the
    virtual CPU devices JAX's step departs from its own unsharded step on
    one leaf, the grouped conv msd/discriminators/1/convs/1 (its gradient
    off by its own magnitude), while (2, 1) and (1, 2) agree with it; the
    port agrees with all three there."""
    jcfg = JHiFiGANConfig(**dataclasses.asdict(W.VOC_CFG))
    mesh = jmake_mesh(1, 2, devices=jax.devices()[:2])
    tx = hifigan_adam(lr=W.GAN_LR)
    tree = jax.tree_util.tree_map(jnp.asarray, init.init_gan_state(0, W.VOC_CFG))
    disc = tree["disc"]["params"]
    with mock.patch.multiple(jhg, init_generator=lambda key, cfg: tree["gen"]["params"],
                             init_mpd=lambda key: disc["mpd"], init_msd=lambda key: disc["msd"]):
        state = jgan.shard_gan_state(jax.random.PRNGKey(0), jcfg, tx, tx, mesh)
    state, m = jgan.make_gan_train_step(jcfg, tx, tx)(state, jstep.shard_batch(
        {k: jnp.asarray(v) for k, v in W.gan_batch().items()}, mesh))
    params = {side: {"params": jax.tree_util.tree_map(np.asarray, state[side]["params"])} for side in ("gen", "disc")}
    mu = {side: {"params": jax.tree_util.tree_map(np.asarray, state[side]["opt_state"][0].mu)}
          for side in ("gen", "disc")}
    return np.array([float(m[k]) for k in W.GAN_METRICS]), W.gan_leaves(params), W.gan_leaves(mu)


def _jax_cpu():
    jax.config.update("jax_platforms", "cpu")


def _jax_cnn():
    out = {("cnn", mode): _jax_acoustic(W.CNN_CFG, W.MODES[mode], mode == "sp") for mode in CNN_MODES}
    out.update({("cnn", mode): _jax_acoustic(cfg, W.MODES["dp"], accum=accum)
                for mode, (cfg, accum) in W.DP_VARIANTS.items()})
    return out


def _jax_transformer_and_init():
    return {**{("tr", mode): _jax_acoustic(W.TR_CFG, W.MODES[mode]) for mode in ("dp", "tp")}, "init": _jax_redrawn()}


def _jax_transformer_sp():
    return {("tr", mode): _jax_acoustic(W.TR_CFG, W.MODES[mode], sp=True) for mode in ("sp", "dp+sp")}


@pytest.fixture(scope="module")
def jax_steps(launches):
    """JAX's sharded steps, computed while the ranks run, in four processes
    of their own (with this one's environment: the virtual CPU devices):
    EFTS-CNN's, the transformer's dp and tp with `initialize`'s, its sp and
    dp+sp, and the GAN's (20 s of XLA compile)."""
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"), initializer=_jax_cpu) as pool:
        parts = [pool.submit(f) for f in (_jax_gan, _jax_cnn, _jax_transformer_and_init, _jax_transformer_sp)]
        gan, cnn, rest, sp = (p.result() for p in parts)
        return {**cnn, **rest, **sp, "gan": gan}


def _sub(r, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in r.items() if k.startswith(prefix + "/")}


def _sure(mu, floor=1e-5):
    """The entries whose first moment is above 1e-3 of the leaf's max and
    `floor` of the whole tree's (a leaf whose true gradient is 0, as the
    attention key's bias under a softmax, holds rounding only)."""
    top = max(float(np.abs(v).max()) for v in mu.values())
    return {k: (np.abs(v) > 1e-3 * np.abs(v).max()) & (np.abs(v) > floor * top) for k, v in mu.items()}


def _assert_updates(got, want, p0, sure, rtol, share=0.8):
    """The updates p - p0 of the `sure` entries as `_assert_leaves` holds
    leaves: within rtol of the leaf's largest update, plus 1e-7 of the
    tree's, plus 2 ulps of the leaf's largest parameter (an f32 parameter
    near 1, a norm's scale, moves by whole ulps); `share` of the entries are
    sure."""
    assert set(got) == set(want) == set(p0)
    top = max(float(np.abs(want[k] - p0[k]).max()) for k in want)
    n = 0
    for k in got:
        s = sure[k]
        d_got, d_want = (got[k] - p0[k])[s], (want[k] - p0[k])[s]
        if s.any():
            ulps = 2 * float(np.spacing(np.abs(p0[k]).max().astype(np.float32)))
            assert np.abs(d_got - d_want).max() <= rtol * np.abs(want[k] - p0[k]).max() + 1e-7 * top + ulps, k
        n += int(s.sum())
    assert n > share * sum(v.size for v in p0.values())


def _assert_leaves(got, want, rtol, gtol=1e-7):
    """Each leaf within rtol of its own max, plus gtol of the largest leaf's
    (`test_torch_port_cnn_training.py:_assert_trees_close`)."""
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in got:
        assert np.abs(got[k] - want[k]).max() <= rtol * np.abs(want[k]).max() + gtol * top, k


@pytest.mark.parametrize("model,mode", [("cnn", m) for m in [*CNN_MODES, *W.DP_VARIANTS]]
                         + [("tr", m) for m in TR_MODES])
def test_acoustic_step_matches_jax_sharded_step(ranks, jax_steps, model, mode):
    """Every mode, and dp with 2 micro-batches under the other
    normalizations of the losses (`loss_normalize: utterance`,
    `use_masking: False`): JAX cuts the micro-batches from the global batch
    before it shards them. The sure entries are those of the one-process
    step, or for a variant those of its own first moment."""
    metrics, p0, p1 = jax_steps[model, mode]
    world = (CNN_MODES if model == "cnn" else TR_MODES).get(mode, "world2")
    mu = _sub(ranks["one"][0], f"{model}/mu1") if mode not in W.DP_VARIANTS else _sub(ranks[world][0],
                                                                                       f"cnn_{mode}/mu1")
    for r in ranks[world]:
        np.testing.assert_allclose(r[f"{model}_{mode}/m1"], metrics, rtol=JAX_RTOL)
        _assert_updates(_sub(r, f"{model}_{mode}/p1"), p1, p0, _sure(mu), 1e-3)


ONE_PROCESS_CNN_MODES = {**CNN_MODES, "dp_accum2": "world2", "dp+sp": "world4"}


@pytest.mark.parametrize("model,mode", [("cnn", m) for m in ONE_PROCESS_CNN_MODES] + [("tr", m) for m in TR_MODES])
def test_acoustic_step_matches_one_process(ranks, model, mode):
    """dp_accum2: dp with 2 micro-batches a rank, weighted over the global
    counts; dp+sp: the frames split on each data row; each against one
    process's whole batch."""
    one = ranks["one"][0]
    world = ONE_PROCESS_CNN_MODES[mode] if model == "cnn" else TR_MODES[mode]
    p0 = W.flat(W.tree(W.CNN_CFG if model == "cnn" else W.TR_CFG))
    sure = _sure(_sub(one, f"{model}/mu1"))
    first = ranks[world][0]
    for r in ranks[world]:
        for i in (1, 2):
            np.testing.assert_allclose(r[f"{model}_{mode}/m{i}"], one[f"{model}/m{i}"], rtol=ONE_RTOL)
            # the ranks hold one state: gathered, it is bit-equal on every rank
            for k, v in _sub(r, f"{model}_{mode}/p{i}").items():
                np.testing.assert_array_equal(v, first[f"{model}_{mode}/p{i}/{k}"])
        _assert_leaves(_sub(r, f"{model}_{mode}/mu1"), _sub(one, f"{model}/mu1"), 1e-4)
        for i in (1, 2):
            _assert_updates(_sub(r, f"{model}_{mode}/p{i}"), _sub(one, f"{model}/p{i}"), p0, sure, 1e-4)


def test_ragged_ranks_need_the_global_weighting(ranks, jax_steps):
    """Data row 0 holds the short rows: the naive average of the two blocks'
    means misses JAX's loss by far more than the tolerance the dp step holds."""
    jloss = jax_steps["cnn", "dp"][0][0]
    r0, r1 = ranks["world2"]
    naive = 0.5 * (float(r0["cnn_dp/block_loss"]) + float(r1["cnn_dp/block_loss"]))
    assert abs(naive - jloss) > 100 * JAX_RTOL * abs(jloss)
    assert float(r0["cnn_dp/m1"][0]) == pytest.approx(jloss, rel=JAX_RTOL)


@pytest.mark.parametrize("mode", list(GAN_MODES))
def test_gan_step_matches_jax_and_one_process(ranks, jax_steps, mode):
    metrics, p1_j, mu_j = jax_steps["gan"]
    one = ranks["one"][0]
    p0 = W.gan_leaves({side: {"params": init.init_gan_state(0, W.VOC_CFG)[side]["params"]} for side in ("gen", "disc")})
    sure = _sure({k: v for k, v in _sub(one, "gan/mu1").items() if k in p0}, floor=0.0)
    for r in ranks[GAN_MODES[mode]]:
        np.testing.assert_allclose(r[f"gan_{mode}/m1"], metrics, rtol=JAX_RTOL)
        np.testing.assert_allclose(r[f"gan_{mode}/m1"], one["gan/m1"], rtol=ONE_RTOL)
        p1 = {k: v for k, v in _sub(r, f"gan_{mode}/p1").items() if k in p0}
        disc = [k for k in p1 if k.startswith("disc/")]
        _assert_updates(*({k: t[k] for k in disc} for t in (p1, p1_j, p0)), sure, 1e-3, share=0.7)
        _assert_leaves({k: p1[k] for k in disc}, {k: one[f"gan/p1/{k}"] for k in disc}, 1e-4)
        mu = {k: v for k, v in _sub(r, f"gan_{mode}/mu1").items() if k in p0}
        for side, bound, gtol in (("gen", 1e-3, 2e-4), ("disc", 1e-4, 1e-6)):
            pick = [k for k in mu if k.startswith(side + "/")]
            _assert_leaves({k: mu[k] for k in pick}, {k: mu_j[k] for k in pick}, bound, gtol)
            _assert_leaves({k: mu[k] for k in pick}, {k: one[f"gan/mu1/{k}"] for k in pick}, bound, gtol)
        # spectral norm's u, advanced on every rank from equal weights
        np.testing.assert_array_equal(r[f"gan_{mode}/sn_u"], ranks[GAN_MODES[mode]][0][f"gan_{mode}/sn_u"])


def test_tp_gradients_are_the_slices_of_the_whole_gradients(ranks):
    """A column-parallel layer's gradient is its slice of the whole one (not
    the model extent times it) and a replicated leaf's is whole, for
    EFTS-CNN and for a generator, whose transposed convs normalize across the
    shards."""
    for r in ranks["world2"]:
        index = int(r is ranks["world2"][1])
        for name in ("cnn", "gen"):
            specs = json.loads(str(r[f"{name}_specs"]))
            tp, whole = _sub(r, f"{name}_grad_tp"), _sub(r, f"{name}_grad_whole")
            assert set(tp) == set(whole) and any(a is not None for a in specs.values())
            top = max(float(np.abs(v).max()) for v in whole.values())
            for k, g in tp.items():
                want = whole[k]
                axis = specs.get(k)
                if axis is not None:
                    n = want.shape[axis] // 2
                    want = np.take(want, range(index * n, (index + 1) * n), axis=axis)
                assert g.shape == want.shape, k
                assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max() + 1e-7 * top, k
        np.testing.assert_allclose(r["gen_out_tp"], r["gen_out_whole"], rtol=0, atol=1e-6)
        n = r["gen_ups0_weight_whole"].shape[1] // 2
        np.testing.assert_allclose(r["gen_ups0_weight_tp"], r["gen_ups0_weight_whole"][:, index * n:(index + 1) * n],
                                   rtol=1e-6, atol=1e-8)


def test_grad_norm_is_global_and_the_clip_acts_on_it(ranks):
    """The yaml clips at norm 1: the one-process norm is above it, so the tp
    and sp updates above (held to one process) went through the clip with
    the global norm, which each rank reports."""
    one = ranks["one"][0]
    assert one["cnn/m1"][3] > 1.0 and one["tr/m1"][3] > 1.0
    for mode in ("tp", "sp"):
        for r in ranks["world2"]:
            assert r[f"cnn_{mode}/m1"][3] == pytest.approx(one["cnn/m1"][3], rel=ONE_RTOL)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return tuple(t.shape) if torch.is_tensor(t) else t


@pytest.fixture(scope="module")
def one_process_trainer(tmp_path_factory):
    """One process's EftsTrainer after one step on the global batch: its
    eval and the shapes of its checkpoint (the eval images are not drawn)."""
    _, model, _ = W.acoustic(W.CNN_CFG)
    tx = optimizer_from_dict(W.optimizer_config())
    one = EftsTrainer(W.CNN_CFG, tx, iter([(0, W.batch())]), eval_batches=[W.batch()],
                      outdir=str(tmp_path_factory.mktemp("one_trainer")), train_max_steps=1,
                      save_interval_steps=1000, eval_interval_steps=1000, device="cpu")
    one.init_state(model)
    one.run()
    with mock.patch.object(plotting, "available", lambda: False):
        evaluated = one.evaluate(1)
    return evaluated, _shapes(ckpt.read_checkpoint(one.save()))


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_checkpoint_is_the_one_card_file_and_resumes_on_one_process(ranks, one_process_trainer, tmp_path, mode):
    r0, r1 = ranks["world2"]
    path = str(r0[f"ckpt_{mode}/path"])
    assert str(r1[f"ckpt_{mode}/path"]) == path
    assert int(r0["ckpt/writes"]) == 2 and int(r1["ckpt/writes"]) == 0
    saved = ckpt.read_checkpoint(path)
    evaluated, shapes = one_process_trainer
    # the mesh's eval: its batch split over the data rows, the losses weighted globally
    np.testing.assert_allclose(r0[f"ckpt_{mode}/eval"], [evaluated[k] for k in W.METRICS[:3]], rtol=ONE_RTOL)
    assert _shapes(saved) == shapes
    resumed = EftsTrainer(W.CNN_CFG, optimizer_from_dict(W.optimizer_config()), iter([(0, W.batch())] * 2),
                          outdir=str(tmp_path / "resumed"), train_max_steps=2, save_interval_steps=1000,
                          device="cpu")
    resumed.init_state(W.acoustic(W.CNN_CFG)[1])
    resumed.load(path)
    for k, v in resumed.state["params"].state_dict().items():
        assert torch.equal(v, saved["params"][k])
    resumed.run()
    got = W.flat(W.acoustic_jax(W.CNN_CFG, resumed.state["params"].state_dict()))
    _assert_leaves(got, _sub(r0, f"ckpt_{mode}/p2"), 1e-4)


def test_dropout_is_seeded_per_data_row(ranks):
    """The masks: equal across a model row, different across data rows; a
    dp+tp step with dropout keeps the row's replicated compute equal, so the
    gathered state is equal on every rank."""
    m = [r["dropout_mask"] for r in ranks["world4"]]
    np.testing.assert_array_equal(m[0], m[1])
    np.testing.assert_array_equal(m[2], m[3])
    assert (m[0] != m[2]).mean() > 0.2
    first = ranks["world4"][0]
    for r in ranks["world4"]:
        assert np.isfinite(r["cnn_dropout/m1"]).all()
        for k, v in _sub(r, "cnn_dropout/p2").items():
            np.testing.assert_array_equal(v, first[f"cnn_dropout/p2/{k}"])


def test_two_rank_train_cli(ranks):
    r0, r1 = ranks["world2"]
    assert int(r0["cli_train/data_extent"]) == 2
    assert float(r0["cli_train/loss1"]) == pytest.approx(float(ranks["one"][0]["cli_train/loss1"]), rel=ONE_RTOL)
    np.testing.assert_array_equal(r0["cli_train/losses"], r1["cli_train/losses"])
    for k, v in _sub(r0, "cli_train/params").items():
        np.testing.assert_array_equal(v, r1[f"cli_train/params/{k}"])
    # rank 0 wrote both configs and the checkpoints, rank 1 nothing
    assert r0["cli/writes"][0] == 2 and r0["cli/writes"][1] >= 2
    np.testing.assert_array_equal(r1["cli/writes"], [0, 0])


def test_two_rank_vocoder_cli(ranks, launches):
    r0, r1 = ranks["world2"]
    assert str(r0["cli_voc/data_path"]) == "host"
    assert float(r0["cli_voc/g_loss1"]) == pytest.approx(float(ranks["one"][0]["cli_voc/g_loss1"]), rel=ONE_RTOL)
    assert int(r0["cli_voc/evals"]) == 1 and int(r1["cli_voc/evals"]) == 0
    assert str(r0["cli_voc/params_sha256"]) == str(r1["cli_voc/params_sha256"])
    assert int(r0["cli_voc/saved_step"]) == 2 and "disc" in list(r0["cli_voc/saved_keys"])


def test_vocoder_device_corpus_on_raises_in_a_world(monkeypatch, tmp_path):
    monkeypatch.setattr(train_vocoder, "join_ranks", lambda args, device: (2, torch.device("cpu")))
    with pytest.raises(ValueError, match="device_corpus on in a world of 2"):
        train_vocoder.main(["--wav_scp", "x.scp", "--outdir", str(tmp_path), "--device_corpus", "on", "--use_cpu"])


# the EFTS-Transformer's sequence-parallel pieces on one process: a rank's
# rows (T2 = 384 over m = 4: 96 rows, padded to 128 on the flash path)
# against the whole sequence's

SP_T, SP_M = 384, 4


@pytest.fixture
def one_thread():
    """One intra-op thread: these shapes are small, and Tier-1's six workers
    share the host's cores (their OpenMP threads spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sp_inputs():
    rng = np.random.default_rng(11)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((3, 2, SP_T, 8)).astype(np.float32)) for _ in range(4))
    lengths = torch.tensor([SP_T, 200, 50])
    return q, k, v, w, (torch.arange(SP_T)[None, :] < lengths[:, None])[:, None, :]


def _attend_grads(q, k, v, w, **kw):
    """(output, dq, dk, dv) of sum(output * w) through `attend`."""
    from efficient_tts_tpu_torch.nn.attention import attend

    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attend(*xs, **kw)
    return (out.detach(), *torch.autograd.grad((out * w).sum(), xs))


@pytest.mark.parametrize("impl", ["flash_plain", "xla"])
def test_sequence_parallel_attention_rows_match_the_whole_sequence(impl, one_thread):
    """Each rank's query rows against the whole sequence's keys, with key
    padding (a short row whose later ranks hold pad queries only): the
    rows of the whole attention, and the ranks' key and value gradients sum
    to the whole's (the padded rows add nothing)."""
    q, k, v, w, mask = _sp_inputs()
    out, dq, dk, dv = _attend_grads(q, k, v, w, mask=mask, impl=impl)
    t = SP_T // SP_M
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for i in range(SP_M):
        rows = slice(i * t, (i + 1) * t)
        o_i, dq_i, dk_i, dv_i = _attend_grads(q[:, :, rows], k, v, w[:, :, rows], mask=mask, impl=impl, start=i * t)
        assert o_i.shape == (3, 2, t, 8)
        torch.testing.assert_close(o_i, out[:, :, rows], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(dq_i, dq[:, :, rows], rtol=1e-6, atol=1e-7)
        dk_sum, dv_sum = dk_sum + dk_i, dv_sum + dv_i
    torch.testing.assert_close(dk_sum, dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-5, atol=1e-6)


def test_positional_encoding_of_a_rank_is_its_rows_of_the_whole_table(one_thread):
    from efficient_tts_tpu_torch.nn.attention import add_positional_encoding

    x = torch.from_numpy(np.random.default_rng(12).standard_normal((2, SP_T, 16)).astype(np.float32))
    whole = add_positional_encoding(x, scale=torch.tensor(1.5))
    t = SP_T // SP_M
    for i in range(SP_M):
        rows = slice(i * t, (i + 1) * t)
        got = add_positional_encoding(x[:, rows], scale=torch.tensor(1.5), offset=i * t)
        torch.testing.assert_close(got, whole[:, rows], rtol=0, atol=0)


def test_attention_dropout_of_a_rank_is_its_rows_of_the_whole_mask(one_thread):
    """The XLA branch in training: a rank's attention probabilities take
    their rows of the [B, H, T, T] mask the whole sequence draws (every rank
    of a model row holds the same generator)."""
    q, k, v, w, mask = _sp_inputs()
    kw = dict(mask=mask, impl="xla", dropout_rate=0.3, deterministic=False)
    out = _attend_grads(q, k, v, w, gen=torch.Generator().manual_seed(5), **kw)[0]
    plain = _attend_grads(q, k, v, w, mask=mask, impl="xla")[0]
    assert (out - plain).abs().max() > 1e-2  # the mask drops probabilities
    t = SP_T // SP_M
    for i in range(SP_M):
        rows = slice(i * t, (i + 1) * t)
        got = _attend_grads(q[:, :, rows], k, v, w[:, :, rows], gen=torch.Generator().manual_seed(5), start=i * t,
                            **kw)[0]
        torch.testing.assert_close(got, out[:, :, rows], rtol=1e-6, atol=1e-7)


def test_device_prefetch_with_a_mesh_keeps_the_rank_rows():
    mesh = type("M", (), {"shape": {"data": 2, "model": 1}, "member": True, "data_index": 1})()
    batches = [(0, W.batch())]
    (_, got), = device_prefetch(iter(batches), device="cpu", mesh=mesh)
    for k, v in W.batch().items():
        np.testing.assert_array_equal(got[k].numpy(), v[4:])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_split_batch_with_micro_batches_takes_the_rank_rows_of_each(as_tensor):
    """With 2 micro-batches over 2 data rows, JAX's placement: data row 1
    holds rows 2-3 of micro-batch 0 and rows 6-7 of micro-batch 1; the
    prefetch keeps the same rows."""
    x = np.arange(8) * 10
    x = torch.from_numpy(x) if as_tensor else x
    for index, want in ((0, [0, 10, 40, 50]), (1, [20, 30, 60, 70])):
        mesh = type("M", (), {"shape": {"data": 2, "model": 1}, "member": True, "data_index": index})()
        np.testing.assert_array_equal(np.asarray(split_batch(x, mesh, 2)), want)
        np.testing.assert_array_equal(np.asarray(split_batch(x, mesh)), np.asarray(x)[4 * index:4 * index + 4])
    (_, got), = device_prefetch(iter([(0, {"x": np.arange(8) * 10})]), device="cpu", mesh=mesh, accum_steps=2)
    np.testing.assert_array_equal(got["x"].numpy(), [20, 30, 60, 70])
    with pytest.raises(ValueError, match="accum_steps=3"):
        split_batch(x, mesh, 3)


# nn/init.py and version.py

INIT_TYPES = ("xavier_uniform", "xavier_normal", "kaiming_uniform", "kaiming_normal")


def _init_models(small=False):
    """(JAX-layout tree, its port model, to_jax) of EFTS-CNN's trainable
    model (weight norm as {v, g}) and of a trainable generator; `small`
    narrows both, for JAX's eager `initialize` (a compile per leaf shape)."""
    cnn_cfg, voc_cfg = W.CNN_CFG, W.VOC_CFG
    if small:
        cnn_cfg = dataclasses.replace(cnn_cfg, symbol_embedding_dim=8, n_channels=8, n_text_encoder_layer=1,
                                      n_mel_encoder_layer=1, n_decoder_layer=1)
        voc_cfg = dataclasses.replace(voc_cfg, upsample_initial_channel=16, resblock_dilation_sizes=((1,),))
    cnn, gen = init.init_efts(0, cnn_cfg), init.init_generator(1, voc_cfg)
    return ((cnn, compat.efts_cnn_from_jax(cnn, cnn_cfg, device="cpu", trainable=True), compat.efts_cnn_to_jax),
            (gen, compat.generator_from_jax(gen, voc_cfg, device="cpu"), compat.generator_to_jax))


def _redrawn(tree, model, to_jax, init_type):
    before = W.flat(tree)
    tinit.initialize(model, init_type, torch.Generator().manual_seed(0), device="cpu")
    after = W.flat(to_jax(model))
    return before, after, {k for k, v in after.items() if not np.array_equal(v, before[k])}


def _jax_redrawn():
    """The paths of the leaves JAX's `initialize` re-draws, per model of
    `_init_models(small=True)`; jitted (the fans, of static shapes, taken
    at trace time), not dispatched leaf by leaf."""
    out = []
    for tree, _, _ in _init_models(small=True):
        with jax.ensure_compile_time_eval():
            jtree = jax.jit(jinit.initialize, static_argnums=1)(jax.tree_util.tree_map(jnp.asarray, tree),
                                                                "xavier_uniform", jax.random.PRNGKey(0))
        before = W.flat(tree)
        out.append({k for k, v in W.flat(jax.tree_util.tree_map(np.asarray, jtree)).items()
                    if not np.array_equal(v, before[k])})
    return out


def test_initialize_redraws_the_leaves_jax_redraws(jax_steps):
    """The re-drawn leaves are exactly those JAX's `initialize` re-draws, by
    the JAX tree's path (rank >= 2, weight norm's g included)."""
    for (tree, model, to_jax), jchanged in zip(_init_models(small=True), jax_steps["init"], strict=True):
        _, _, changed = _redrawn(tree, model, to_jax, "xavier_uniform")
        assert changed == jchanged and any(k.endswith("/g") for k in changed)


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_initialize_draws_with_the_fans_of_the_jax_shapes(init_type):
    """Each re-drawn leaf's bound (uniform) or std (normal) is the one JAX's
    fans give its shape in the JAX tree; the port's own map of its layouts to
    those shapes gives the same scales, leaf for leaf."""
    for tree, model, to_jax in _init_models():
        shapes = tinit.jax_shapes(model)
        before, after, changed = _redrawn(tree, model, to_jax, init_type)
        wants = {}
        for k in changed:
            fan_in, fan_out = (int(x) for x in jinit._fans(before[k].shape))
            wants[k] = {"xavier_uniform": np.sqrt(6.0 / (fan_in + fan_out)),
                        "xavier_normal": np.sqrt(2.0 / (fan_in + fan_out)),
                        "kaiming_uniform": np.sqrt(6.0 / fan_in), "kaiming_normal": np.sqrt(2.0 / fan_in)}[init_type]
        np.testing.assert_allclose(sorted(tinit.scale(init_type, s) for s in shapes.values()),
                                   sorted(wants.values()), rtol=1e-6)
        for k, want in wants.items():
            x = after[k]
            if init_type.endswith("uniform"):
                assert np.abs(x).max() <= want * (1 + 1e-6)
                if x.size >= 1000:
                    assert np.abs(x).max() >= 0.95 * want
            elif x.size >= 1000:
                assert np.std(x) == pytest.approx(want, rel=0.1)


def test_initialize_rejects_an_unknown_init_type():
    model = compat.efts_cnn_from_jax(init.init_efts(0, W.CNN_CFG), W.CNN_CFG, device="cpu", trainable=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="unknown init_type"):
        tinit.initialize(model, "orthogonal", torch.Generator(), device="cpu")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_version_is_the_packages():
    from efficient_tts_tpu.version import __version__ as jversion

    assert __version__ == module_version == jversion
