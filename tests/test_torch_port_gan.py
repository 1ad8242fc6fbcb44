"""Port HiFi-GAN training (the GAN step and its parts) against the JAX package, on the CPU.

The JAX tests' narrow generator (initial channel 64, one kernel 3,
dilations (1, 3), segment 2048) with the full MPD and MSD, B=2, and the
JAX training test's batch (a 220 Hz tone plus seeded noise, its mel and its
full-band loss mel). Parameters come from `jax.random` through the JAX
package's own init (one GAN state for the module's discriminator, step
and bridge tests) and cross to the port through `compat`; other inputs are
seeded with numpy. Tolerances, f32 on both sides:
  * the tensor log-mel against `dsp/mel.py:mel_spectrogram`: max error
    <= 1e-5 of the reference's range;
  * the trainable generator's waveform, ResBlock1 and ResBlock2: 1e-6
    absolute (it lies in [-1, 1]); its `fold`, and each weight-normed
    layer's, equals `hifigan_generator_from_jax` on the same tree bit for
    bit;
  * both discriminators' logits and feature maps, the port's fused and
    pairwise passes against JAX's: rtol 1e-5, atol 1e-6;
  * spectral norm's sigma and one power iteration: atol 1e-6 (the weight
    w_orig / sigma rtol 1e-5);
  * the GAN losses and the multi-resolution STFT loss: relative 1e-5;
  * `HiFiGANAdam` against optax's `hifigan_adam` on equal gradients over 3
    steps across an epoch boundary: rtol 1e-6;
  * one JAX compile of the f32 GAN step (with the STFT loss and an EMA of
    0.99), shared by a module fixture, against the port's step from the
    same parameters: every metric of both steps within 1e-5 relative; each
    discriminator gradient leaf within 1e-4 of its own max abs, each
    generator leaf within 1e-3 of its own (the gradients are read from the
    first Adam moment, mu = (1 - b1) g, on both sides); u and v after each
    step within 1e-6; the EMA after two steps within (1 - d) * 6 * lr. The
    generator's bound is not the discriminators': its gradient reaches the
    waveform through the discriminators' input gradients (sums with heavy
    cancellation) and leaky-ReLU slopes that flip at activations within
    rounding of 0, so f32 pins it only to about 3e-4 of a leaf's max. JAX
    against itself shows that floor: its step with the generator in the
    exact plain layout (`pack_small_channels=False`, `ups_impl="dilated"`)
    in place of the packed default gives the same metrics to 7e-8 and
    generator leaves 3.3e-4 apart, discriminator leaves 2.5e-7 (measured on
    this batch, with and without the STFT loss). The EMA's bound is that of
    Adam's first updates, about lr * sign(g), which flip with the sign of a
    gradient near 0: at most 2 lr in a parameter after step 1 and 4 lr after
    step 2, taken in at (1 - d);
  * the bf16 step against the port's own f32 step: d_loss, g_loss and mel_l1
    within 15% (as `test_gan_step_bf16_compute` holds the JAX package's),
    parameters and moments f32;
  * the eval step's mel-L1 against `make_gan_eval_step`: relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.dsp.mel import MelConfig as JMelConfig
from efficient_tts_tpu.dsp.mel import loss_mel_config as jloss_mel_config
from efficient_tts_tpu.dsp.mel import mel_spectrogram as jmel_spectrogram
from efficient_tts_tpu.dsp.mel import mel_spectrogram_np as jmel_np
from efficient_tts_tpu.losses import gan as jgan
from efficient_tts_tpu.losses.stft_loss import multi_resolution_stft_loss as jmr_stft
from efficient_tts_tpu.models import hifigan as jhg
from efficient_tts_tpu.train import hifigan_train_step as jts
from efficient_tts_tpu.train.optim import hifigan_adam
from efficient_tts_tpu_torch import compat
from efficient_tts_tpu_torch.dsp.mel import MelConfig, loss_mel_config, mel_spectrogram
from efficient_tts_tpu_torch.losses import gan
from efficient_tts_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.models.hifigan_train import Discriminators
from efficient_tts_tpu_torch.nn.layers import SNConv1d
from efficient_tts_tpu_torch.train.hifigan_train_step import make_gan_eval_step, make_gan_train_step
from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

KW = dict(upsample_initial_channel=64, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
          segment_size=2048)
JCFG, CFG = jhg.HiFiGANConfig(**KW), HiFiGANConfig(**KW)
EMA, LR = 0.99, 2e-4
STEP_RTOL, D_LEAF, G_LEAF, UV_ATOL = 1e-5, 1e-4, 1e-3, 1e-6



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module: Tier-1 runs six
    workers on the host's cores, and the full-width discriminators' convs
    at one thread a core each ran 8-17x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _batch(b=2, segment=2048):
    rng = np.random.default_rng(0)
    t = np.arange(segment) / 22050.0
    audio = 0.5 * np.sin(2 * np.pi * 220 * t)[None, :] * np.ones((b, 1))
    audio = (audio + 0.01 * rng.standard_normal((b, segment))).astype(np.float32)
    mel = np.stack([jmel_np(a, JMelConfig()).T for a in audio])
    mel_loss = np.stack([jmel_np(a, jloss_mel_config(JMelConfig(), None)).T for a in audio])
    return {"mel": mel, "audio": audio, "mel_loss": mel_loss}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tree():
    """One JAX GAN state from `jax.random` (with an EMA), shared by the
    module's fixtures and tests: drawing the discriminators' 70.7 M
    parameters eagerly took 30-40 s of a CPU run each time."""
    tx = hifigan_adam(lr=LR)
    return jts.init_gan_state(jax.random.PRNGKey(0), JCFG, tx, tx, ema_decay=EMA)


def _port_state(tree):
    return compat.gan_state_from_jax(_np(tree), CFG, HiFiGANAdam(lr=LR), HiFiGANAdam(lr=LR), device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("fmax", [8000.0, None], ids=["inference_band", "loss_full_band"])
def test_device_mel_matches_jax(fmax):
    rng = np.random.default_rng(1)
    y = (0.5 * rng.standard_normal((2, 4096))).astype(np.float32)
    want = np.asarray(jmel_spectrogram(jnp.asarray(y), jloss_mel_config(JMelConfig(), fmax)))
    got = mel_spectrogram(_t(y), loss_mel_config(MelConfig(), fmax)).numpy()
    assert got.shape == want.shape == (2, 80, 16)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ResBlock2 (V2/V3's branches) at the same narrow width, dilations (1, 3)
RB2 = {**KW, "resblock": "2"}


@pytest.mark.parametrize("kw", [KW, RB2], ids=["resblock1", "resblock2"])
def test_train_generator_matches_jax_and_folds_bit_for_bit(kw):
    jcfg, cfg = jhg.HiFiGANConfig(**kw), HiFiGANConfig(**kw)
    params = jhg.init_generator(jax.random.PRNGKey(3), jcfg)
    mel = _batch()["mel"]
    want = np.asarray(jax.jit(lambda p, m: jhg.generator(p, m, jcfg))(params, mel))
    gen = compat.generator_from_jax(_np(params), cfg, device="cpu")
    assert all(p.requires_grad for p in gen.parameters())
    assert tuple(gen.ups[0].g.shape) == (64, 1, 1)  # the transposed conv's norm per input channel
    got = gen(_t(mel)).detach().numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    folded, bridged = gen.fold(), compat.hifigan_generator_from_jax(_np(params), cfg, device="cpu")
    sd, ref = folded.state_dict(), bridged.state_dict()
    assert sd.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], ref[k]), k
    # the round trip through the JAX layout is exact
    back = compat.generator_to_jax(gen)
    for (path, a), (_, b) in zip(_leaves(_np(params)), _leaves(back)):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    # each weight-normed layer's own fold gives the inference layer's weights
    for plain, trained in ((bridged.conv_pre, gen.conv_pre), (bridged.ups[1], gen.ups[1]),
                           (bridged.conv_post, gen.conv_post)):
        layer = trained.fold()
        assert type(layer) is type(plain) and not layer.weight.requires_grad
        assert torch.equal(layer.weight, plain.weight) and torch.equal(layer.bias, plain.bias)


@pytest.fixture(scope="module")
def disc_pair(jax_tree):
    """JAX's MPD and MSD of the shared state (the MSD's u and v advanced by 3
    power iterations, as training advances them before every forward, so the
    spectral-normed tower runs at its weights' scale and not at a random
    sigma's), their pairwise outputs from one compile (JAX's fused pass is
    the same numbers,
    `test_hifigan_training.py:test_fused_discriminator_forward_matches_pairwise`),
    and the port's modules."""
    msd = jax_tree["disc"]["params"]["msd"]
    for _ in range(3):
        msd = jhg.msd_power_iteration(msd)
    params = {"mpd": jax_tree["disc"]["params"]["mpd"], "msd": msd}
    tree = {"gen": {"params": jax_tree["gen"]["params"]}, "disc": {"params": params}, "step": 0}
    port = _port_state(tree)["disc"]["params"]
    rng = np.random.default_rng(2)
    y, y_hat = (0.3 * rng.standard_normal((2, 2, 2048))).astype(np.float32)

    @jax.jit
    def forward(params, y, y_hat):
        return {which: fn(params[which], y, y_hat) for which, fn in (("mpd", jhg.mpd_forward),
                                                                     ("msd", jhg.msd_forward))}

    return forward(params, y, y_hat), port, y, y_hat


@pytest.mark.parametrize("which", ["mpd", "msd"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "pairwise"])
def test_discriminators_match_jax(disc_pair, which, fused):
    outputs, port, y, y_hat = disc_pair
    want = outputs[which]
    with torch.no_grad():
        got = getattr(port, which)(_t(y), _t(y_hat), fused=fused)
    n = 0
    for w_part, g_part in zip(want, got):  # real logits, fake logits, real fmaps, fake fmaps
        for a, b in zip(jax.tree_util.tree_leaves(w_part), jax.tree_util.tree_leaves(g_part)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
            n += 1
    # two logits and two feature maps a layer (5 + post, 7 + post) per discriminator
    assert n == (2 + 2 * 6) * 5 if which == "mpd" else n == (2 + 2 * 8) * 3


def test_spectral_norm_matches_jax():
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    p = jhg.spectral_norm_init(k2, jhg.conv1d_init(k1, 128 // 4, 128, 41))
    conv = SNConv1d(128, 128, 41, stride=2, groups=4, padding=20)
    compat._load_entries([(("w_orig",), conv.w_orig, "conv"), (("u",), conv.u, "same"), (("v",), conv.v, "same"),
                          (("b",), conv.bias, "same")], _np(p))
    sigma = float(jnp.dot(p["u"], jhg._sn_matrix(p["w_orig"]) @ p["v"]))
    assert abs(float(conv.sigma()) - sigma) <= 1e-6
    # w_orig / sigma: sigma's relative error, within the discriminators' rtol
    np.testing.assert_allclose(conv.weight().detach().numpy(), np.transpose(np.asarray(jhg._sn_kernel(p)["w"]),
                                                                            (2, 1, 0)), rtol=1e-5, atol=0)
    nxt = jhg.spectral_power_iteration(p)
    conv.power_iteration()
    np.testing.assert_allclose(conv.u.numpy(), np.asarray(nxt["u"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(conv.v.numpy(), np.asarray(nxt["v"]), rtol=0, atol=1e-6)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(4)
    shapes = [[(2, 64, 8), (2, 32, 16), (2, 32)], [(2, 128, 4), (2, 16)]]
    fr = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in shapes]
    fg = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in shapes]
    logits_r = [rng.standard_normal((2, n)).astype(np.float32) for n in (37, 11, 5)]
    logits_g = [rng.standard_normal((2, n)).astype(np.float32) for n in (37, 11, 5)]
    tt = lambda tree: [[_t(x) for x in d] for d in tree]  # noqa: E731
    assert _rel(gan.feature_loss(tt(fr), tt(fg)), jgan.feature_loss(fr, fg)) <= 1e-5
    got, want = gan.discriminator_loss([_t(x) for x in logits_r], [_t(x) for x in logits_g]), \
        jgan.discriminator_loss(logits_r, logits_g)
    for a, b in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        assert _rel(a, b) <= 1e-5
    got, want = gan.generator_loss([_t(x) for x in logits_g]), jgan.generator_loss(logits_g)
    for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert _rel(a, b) <= 1e-5
    x, y = (0.3 * rng.standard_normal((2, 2, 4096))).astype(np.float32)
    for a, b in zip(multi_resolution_stft_loss(_t(x), _t(y)), jmr_stft(jnp.asarray(x), jnp.asarray(y))):
        assert _rel(a, b) <= 1e-5


def test_hifigan_adam_matches_optax():
    """Three updates on equal gradients, two steps an epoch: the third runs
    at lr * 0.999 (the count before the update, 2, is in epoch 1)."""
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    tx, ptx = hifigan_adam(lr=LR, steps_per_epoch=2), HiFiGANAdam(lr=LR, steps_per_epoch=2)
    jstate, pstate = tx.init(params), ptx.init({k: _t(v) for k, v in params.items()})
    for i in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        jup, jstate = tx.update(grads, jstate, params)
        pup, pstate = ptx.update({k: _t(v) for k, v in grads.items()}, pstate, {k: _t(v) for k, v in params.items()})
        for k in params:
            np.testing.assert_allclose(pup[k].numpy(), np.asarray(jup[k]), rtol=1e-6, atol=0)
    assert ptx.schedule(2) == pytest.approx(LR * 0.999, rel=1e-6) and ptx.schedule(1) == pytest.approx(LR)


@pytest.fixture(scope="module")
def steps(jax_tree):
    """The JAX step and the port's, two steps each from the same parameters."""
    batch = _batch()
    tx = hifigan_adam(lr=LR)
    s0 = jax_tree
    jstep = jts.make_gan_train_step(JCFG, tx, tx, use_stft_loss=True, ema_decay=EMA)
    js1, jm1 = jstep(s0, batch)
    js2, jm2 = jstep(js1, batch)
    ptx = HiFiGANAdam(lr=LR)
    st = _port_state(s0)
    pstep = make_gan_train_step(CFG, ptx, ptx, use_stft_loss=True, ema_decay=EMA, device="cpu")
    ema0 = [p.clone() for p in st["ema"].parameters()]
    st, pm1 = pstep(st, batch)
    mu1 = {side: {n: t.clone() for n, t in st[side]["opt_state"]["mu"].items()} for side in ("gen", "disc")}
    p1 = compat.gan_state_to_jax(st)
    gen1 = [p.clone() for p in st["gen"]["params"].parameters()]
    st, pm2 = pstep(st, batch)
    return {"batch": batch, "s0": s0, "jax": [(js1, jm1), (js2, jm2)], "port": [(p1, pm1), (compat.gan_state_to_jax(st),
                                                                                     pm2)],
            "port_state": st, "mu1": mu1, "ema0": ema0, "gen1": gen1}


def test_gan_step_metrics_match_jax(steps):
    keys = {"d_loss", "d_mpd", "d_msd", "g_loss", "mel_l1", "fm", "adv", "stft_sc", "stft_mag"}
    for (_, jm), (_, pm) in zip(steps["jax"], steps["port"]):
        assert set(pm) == set(jm) == keys
        for k in keys:
            assert np.isfinite(float(pm[k])) and _rel(pm[k], jm[k]) <= STEP_RTOL, (k, float(pm[k]), float(jm[k]))


def test_gan_step_gradients_match_jax(steps):
    js1 = steps["jax"][0][0]
    port = compat.gan_state_to_jax(steps["port_state"], grads=steps["mu1"])
    for side, bound in (("gen", G_LEAF), ("disc", D_LEAF)):
        want, got = _leaves(js1[side]["opt_state"][0].mu), _leaves(port[side]["params"])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, a), (_, b) in zip(want, got):
            a = np.asarray(a)
            assert np.abs(b - a).max() <= bound * np.abs(a).max(), (side, jax.tree_util.keystr(path))


def test_gan_step_spectral_state_matches_jax(steps):
    for (js, _), (ps, _) in zip(steps["jax"], steps["port"]):
        for j, p in zip(js["disc"]["params"]["msd"]["discriminators"][0]["convs"],
                        ps["disc"]["params"]["msd"]["discriminators"][0]["convs"]):
            for k in ("u", "v"):
                np.testing.assert_allclose(p[k], np.asarray(j[k]), rtol=0, atol=UV_ATOL)
    # u moved at each step (the power iteration ran once per step)
    u0 = np.asarray(steps["s0"]["disc"]["params"]["msd"]["discriminators"][0]["convs"][0]["u"])
    u1, u2 = (ps["disc"]["params"]["msd"]["discriminators"][0]["convs"][0]["u"] for ps, _ in steps["port"])
    assert not np.allclose(u0, u1) and not np.allclose(u1, u2)


def test_gan_step_ema_matches_jax(steps):
    st = steps["port_state"]
    # the port's EMA is exactly e * d + p * (1 - d) of its own iterates
    for e0, p1, p2, e2 in zip(steps["ema0"], steps["gen1"], st["gen"]["params"].parameters(), st["ema"].parameters()):
        e1 = e0 * EMA + p1 * (1.0 - EMA)
        assert torch.equal(e2, e1 * EMA + p2.detach() * (1.0 - EMA))
    want, got = _leaves(steps["jax"][1][0]["ema"]), _leaves(steps["port"][1][0]["ema"])
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=(1 - EMA) * 6 * LR,
                                   err_msg=jax.tree_util.keystr(path))


def test_gan_step_bf16_against_f32(steps):
    ptx = HiFiGANAdam(lr=LR)
    st = _port_state(steps["s0"])
    st, m16 = make_gan_train_step(CFG, ptx, ptx, use_stft_loss=True, ema_decay=EMA, compute_dtype=torch.bfloat16,
                                  device="cpu")(st, steps["batch"])
    m32 = steps["port"][0][1]
    for k in ("d_loss", "g_loss", "mel_l1"):
        assert np.isfinite(float(m16[k])) and _rel(m16[k], m32[k]) < 0.15, k
    for side in ("gen", "disc"):
        assert all(p.dtype == torch.float32 for p in st[side]["params"].parameters())
        assert all(t.dtype == torch.float32 for t in st[side]["opt_state"]["mu"].values())


def test_eval_step_matches_jax(steps):
    gen = steps["s0"]["gen"]["params"]
    want = jts.make_gan_eval_step(JCFG)(gen, steps["batch"])["mel_l1"]
    eval_step = make_gan_eval_step(CFG, device="cpu")
    port_gen = compat.generator_from_jax(_np(gen), CFG, device="cpu")
    out = eval_step(port_gen, steps["batch"])
    assert _rel(out["mel_l1"], want) <= 1e-5
    assert eval_step.loss_mel_cfg == loss_mel_config(MelConfig(), None)
    # a fold made once is taken as it is
    assert float(eval_step(port_gen.fold(), steps["batch"])["mel_l1"]) == float(out["mel_l1"])


def test_gan_bridge_round_trips(jax_tree):
    tree = _np(jax_tree)
    tree["step"] = 3
    state = _port_state(tree)
    assert isinstance(state["disc"]["params"], Discriminators) and state["step"] == 3
    assert not any(p.requires_grad for p in state["ema"].parameters())
    back = compat.gan_state_to_jax(state)
    want = {k: tree[k] for k in ("gen", "disc", "ema")}
    want["gen"], want["disc"] = {"params": tree["gen"]["params"]}, {"params": tree["disc"]["params"]}
    got = {k: back[k] for k in ("gen", "disc", "ema")}
    wl, gl = _leaves(want), _leaves(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        assert a.shape == b.shape and np.array_equal(a, b), jax.tree_util.keystr(path)
    assert back["step"] == 3
    # the MPD's HWIO [5, 1, in, out] weights sit as [out, in, 5, 1], the
    # MSD's grouped WIO [41, in / 4, out] as [out, in / 4, 41]
    d = state["disc"]["params"]
    assert tuple(d.mpd.discriminators[0].convs[1].v.shape) == (128, 32, 5, 1)
    assert tuple(d.msd.discriminators[1].convs[1].v.shape) == (128, 32, 41)
    assert tuple(d.msd.discriminators[0].convs[1].u.shape) == (128,)
