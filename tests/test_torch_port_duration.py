"""The port's DurationModel and its pieces against the JAX package, on the CPU.

Parameters come from the port's seeded numpy init (`init.py`) and go into
both sides: the JAX functions take the numpy tree as it is, the port's
modules through `compat`. Inputs are seeded with numpy. Tolerances, f32 on
both sides:
  * the DurationModel's loss and log-domain outputs (dropout 0), without
    speakers and with "add" and "concat" speaker tables: rtol 1e-5, atol
    1e-6; `inference`'s rounded durations equal JAX's wherever JAX's
    unrounded value is not within 1e-4 of a rounding boundary;
  * the first train step through each side's `make_duration_train_step`,
    with each side's SGD of `optimizer_from_dict` (clip by global norm 1,
    lr 0.1): the loss rtol 1e-5, the updated parameters within 1e-6 of
    lr times the largest gradient plus an f32 ulp of the parameter, so the
    clipped gradients agree;
  * the fit of `tests/test_duration_workflow.py`: 60 steps halve the loss
    and `inference` gives non-negative integers;
  * both collates equal JAX's key for key, and the TTSCollate invariant
    (each row's durations sum to its mel length) holds;
  * the length regulator equals JAX's bit for bit (zero durations, frames
    past the total), the postnet JAX's at rtol 1e-5, atol 1e-5 with
    non-trivial batch-norm state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.data import collate as jcollate
from efficient_tts_tpu.models import duration_model as jdm
from efficient_tts_tpu.models.duration_model import DurationModelConfig as JDurationModelConfig
from efficient_tts_tpu.nn.length_regulator import length_regulator as jlength_regulator
from efficient_tts_tpu.nn.postnet import postnet as jpostnet
from efficient_tts_tpu.train.duration_train_step import make_duration_train_step as jmake_step
from efficient_tts_tpu.utils.config import optimizer_from_dict as joptimizer_from_dict
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.bin import train
from efficient_tts_tpu_torch.data.collate import collate_duration_model, collate_text_mel_durations
from efficient_tts_tpu_torch.models.duration_model import DurationModel, DurationModelConfig
from efficient_tts_tpu_torch.nn.length_regulator import length_regulator
from efficient_tts_tpu_torch.train.duration_train_step import init_duration_state, make_duration_train_step
from efficient_tts_tpu_torch.train.optim import AdamWarmup, optimizer_from_dict
from efficient_tts_tpu_torch.utils.config import model_config_from_dict

SPEAKERS = {"none": {}, "add": dict(num_spks=3, spk_embed_dim=8, spk_embed_integration_type="add"),
            "concat": dict(num_spks=3, spk_embed_dim=8, spk_embed_integration_type="concat", idim=12)}
SGD = {"optimizer_type": "SGD", "optimizer_params": {"lr": 0.1}, "scheduler_type": "none", "grad_norm": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module (Tier-1 runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(mode, **kw):
    return DurationModelConfig(**{**dict(idim=16, duration_predictor_chans=16, duration_predictor_dropout_rate=0.0),
                                  **SPEAKERS[mode], **kw})


def _batch(cfg, b=3, t=16, seed=0):
    rng = np.random.default_rng(seed)
    ppg = rng.standard_normal((b, t, cfg.idim)).astype(np.float32)
    lengths = np.array([t, t - 5, t - 9][:b], np.int32)
    durations = rng.integers(0, 7, (b, t)).astype(np.int32)
    spkids = rng.integers(0, cfg.num_spks or 1, (b,)).astype(np.int32)
    return {"ppg": ppg, "lengths": lengths, "durations": durations, "spkids": spkids}


def _jcfg(cfg):
    return JDurationModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("mode", list(SPEAKERS))
def test_duration_model_matches_jax(mode):
    cfg = _cfg(mode)
    params = init.init_duration_model(1, cfg)
    batch = _batch(cfg)
    spk = batch["spkids"] if cfg.num_spks else None
    want = jdm.forward(params, _jcfg(cfg), jnp.asarray(batch["ppg"]), jnp.asarray(batch["lengths"]),
                       jnp.asarray(batch["durations"]), spkids=None if spk is None else jnp.asarray(spk))
    model = compat.duration_model_from_jax(params, cfg, device="cpu")
    got = model(torch.from_numpy(batch["ppg"]), torch.from_numpy(batch["lengths"]),
                torch.from_numpy(batch["durations"]), spkids=None if spk is None else torch.from_numpy(spk))
    np.testing.assert_allclose(got["d_outs"].numpy(), np.asarray(want["d_outs"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    # inference: rounded linear-domain durations, away from rounding ties
    jinf = jdm.inference(params, _jcfg(cfg), jnp.asarray(batch["ppg"]), None if spk is None else jnp.asarray(spk))
    tinf = model.inference(torch.from_numpy(batch["ppg"]), None if spk is None else torch.from_numpy(spk)).numpy()
    raw = np.clip(np.exp(np.asarray(want["d_outs"])) - 1.0, 0, None)
    away = np.abs(raw - np.floor(raw) - 0.5) > 1e-4
    mask = np.arange(16)[None] < batch["lengths"][:, None]
    assert np.array_equal(tinf[away & mask], np.asarray(jinf)[away & mask])
    assert np.array_equal(tinf, np.round(tinf)) and (tinf >= 0).all()
    # the bridge maps back onto the JAX tree, leaf for leaf
    back = compat.duration_model_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params), strict=True):
        np.testing.assert_array_equal(a, b)


def test_duration_model_keeps_the_reference_width_quirk():
    with pytest.raises(ValueError, match="must equal duration_predictor_chans"):
        DurationModel(_cfg("none", idim=12))
    assert DurationModel(_cfg("concat")).duration_predictor.spk_projection.weight.shape == (16, 12 + 8)


@pytest.mark.parametrize("mode", ["none", "add"])
def test_first_train_step_matches_jax(mode):
    cfg = _cfg(mode)
    params = init.init_duration_model(2, cfg)
    batch = _batch(cfg, seed=3)
    jtx = joptimizer_from_dict(SGD)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, params), "opt_state": None, "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(0)}
    jstate["opt_state"] = jtx.init(jstate["params"])
    jnew, jmetrics = jmake_step(_jcfg(cfg), jtx)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tx = optimizer_from_dict(SGD)
    model = compat.duration_model_from_jax(params, cfg, device="cpu", trainable=True)
    from efficient_tts_tpu_torch.train.state import create_state

    state = {**create_state(model, tx), "rng": 0}
    state, metrics = make_duration_train_step(cfg, tx, device="cpu")(state, batch)
    assert state["step"] == 1 and float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    after = compat.duration_model_to_jax(state["params"])
    moved = [np.abs(np.asarray(a) - b).max() for a, b in zip(jax.tree_util.tree_leaves(jnew["params"]),
                                                             jax.tree_util.tree_leaves(params))]
    bound = 1e-6 * max(moved)  # 1e-6 of lr times the largest clipped gradient
    for a, b in zip(jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(jnew["params"]), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2**-23, atol=bound)
    assert max(moved) > 0


def test_duration_model_trains():
    """`test_duration_workflow.py`'s fit: a linear ppg -> duration mapping is
    learnt; inference gives rounded linear-domain durations."""
    cfg = DurationModelConfig(idim=32, duration_predictor_chans=32, duration_predictor_dropout_rate=0.0)
    tx = AdamWarmup(lr=1e-2, warmup_steps=None, weight_decay=0.0)
    state = init_duration_state(0, cfg, tx, device="cpu")
    step = make_duration_train_step(cfg, tx, device="cpu")
    rng = np.random.default_rng(2)
    ppg = rng.standard_normal((4, 16, 32)).astype(np.float32)
    dur = np.clip(np.abs(ppg[:, :, 0] * 3) + 1, 1, 8).astype(np.int32)
    batch = {"ppg": ppg, "lengths": np.full((4,), 16, np.int32), "durations": dur,
             "spkids": np.zeros((4,), np.int32)}
    losses = []
    for _ in range(60):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    pred = state["params"].inference(torch.from_numpy(ppg)).numpy()
    assert pred.shape == (4, 16) and np.array_equal(pred, np.round(pred)) and (pred >= 0).all()


def test_dropout_draws_a_new_key_each_step():
    """With dropout the step's key comes from the state's, which advances:
    two steps from equal states agree, and a state's next step differs."""
    cfg = _cfg("none", duration_predictor_dropout_rate=0.5)
    tx = optimizer_from_dict(SGD)
    batch = _batch(cfg, seed=4)
    step = make_duration_train_step(cfg, tx, device="cpu")
    a, b = (init_duration_state(5, cfg, tx, device="cpu") for _ in range(2))
    first = a["rng"]
    _, ma = step(a, batch)
    _, mb = step(b, batch)
    assert float(ma["loss"]) == float(mb["loss"]) and a["rng"] == b["rng"] != first
    with torch.no_grad():
        deterministic = a["params"](*(torch.from_numpy(batch[k]) for k in ("ppg", "lengths", "durations")))["loss"]
    _, mc = step(a, batch)
    assert float(mc["loss"]) != float(deterministic)


def test_collates_match_jax():
    rng = np.random.default_rng(0)
    batch = []
    for t1, t2 in [(5, 40), (7, 61), (3, 22)]:
        batch.append((rng.integers(1, 50, t1), rng.integers(1, 5, t1), rng.standard_normal((t2, 8)).astype(np.float32),
                      3))
    for kw in ({"text_bucket": 4, "mel_bucket": 16}, {"n_frames_per_step": 4}):
        got, want = collate_text_mel_durations(batch, **kw), jcollate.collate_text_mel_durations(batch, **kw)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        for i in range(len(batch)):
            assert got["durations"][i].sum() == got["mel_lengths"][i]
    assert (got["spkids"] == 3).all()
    ppgs = [(rng.standard_normal((n, 12)).astype(np.float32), rng.integers(1, 4, n), s) for n, s in ((6, 1), (9, 2))]
    got, want = collate_duration_model(ppgs, bucket=8), jcollate.collate_duration_model(ppgs, bucket=8)
    assert got["ppg"].shape == (2, 16, 12) and (got["durations"][0, 6:] == 0).all()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_length_regulator_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    d = np.array([[2, 0, 3, 1, 0], [1, 1, 1, 1, 1], [0, 0, 4, 0, 2]], np.int32)
    for max_len in (6, 9):  # shorter than a row's total, and past every total
        for pad in (0.0, -1.5):
            want = np.asarray(jlength_regulator(jnp.asarray(x), jnp.asarray(d), max_len, pad))
            got = length_regulator(torch.from_numpy(x), torch.from_numpy(d), max_len, pad).numpy()
            np.testing.assert_array_equal(got, want)


def test_postnet_matches_jax():
    params = init.init_postnet(6, odim=20, n_chans=24)
    rng = np.random.default_rng(6)
    for norm in params["norms"]:  # batch-norm state away from the identity
        c = norm["mean"].shape[0]
        norm.update(mean=rng.standard_normal(c).astype(np.float32) * 0.1,
                    var=rng.uniform(0.5, 2.0, c).astype(np.float32),
                    scale=rng.uniform(0.5, 1.5, c).astype(np.float32), bias=rng.standard_normal(c).astype(np.float32))
    x = rng.standard_normal((2, 30, 20)).astype(np.float32)
    want = np.asarray(jpostnet(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    mod = compat.postnet_from_jax(params, device="cpu")
    got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(compat.postnet_to_jax(mod)), jax.tree_util.tree_leaves(params),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # dropout draws from the given generator, deterministic per seed
    y1, y2 = (mod(torch.from_numpy(x), gen=torch.Generator().manual_seed(1), deterministic=False) for _ in range(2))
    assert torch.equal(y1, y2) and not torch.equal(y1, torch.from_numpy(got))


def test_config_and_the_training_cli(tmp_path):
    """`model_config_from_dict` gives the DurationModel's config; the EFTS
    training CLI refuses it by name before it reads any data."""
    d = {"model_name": "DurationModel", "model_params": {"idim": 64, "duration_predictor_chans": 64, "num_spks": 4,
                                                          "spk_embed_dim": 16}}
    cfg = model_config_from_dict(d)
    assert isinstance(cfg, DurationModelConfig) and cfg.num_spks == 4
    import yaml

    path = tmp_path / "dur.yaml"
    path.write_text(yaml.safe_dump(d))
    with pytest.raises(NotImplementedError, match="DurationModel has no training CLI"):
        train.main(["--config", str(path), "--train_fid_scp", str(tmp_path / "none.txt"), "--outdir",
                    str(tmp_path / "exp"), "--use_cpu"])
