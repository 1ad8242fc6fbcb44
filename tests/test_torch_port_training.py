"""Port EFTS-Transformer training against the JAX package, on the CPU.

A tiny EFTS-Transformer (width 32, 2 heads so dk = 16, ff 64 as a k=3
conv, 2 text-encoder, 1 mel-encoder and 2 decoder layers, 20 mel bins)
gets seeded numpy weights in the JAX tree's layout; the same tree feeds
the JAX functions and, through the bridge (`trainable=True`), the port. A
ragged batch of 3 (T1 = 128, T2 = 256) puts every attention call on the
flash path under attn_impl="flash". JAX's flash kernel runs only on a TPU,
so, as in `test_torch_port_transformer.py`, the JAX side runs its
library's plain reference `mha_reference_no_custom_vjp` with the same
segment ids, patched in for each test only. Dropout is off wherever the
two are compared (the frameworks' random streams differ); its own
properties are tested apart.

Tolerances, f32 on both sides: activations rtol = atol = 1e-5 (1e-4 for
imv and e, which reach a few hundred after cumsums; 5e-5 for the mel
prediction of range 1.6 after 5 jitted layers, whose fused sums XLA
reorders: 1.4e-5 seen); every gradient leaf
within 1e-4 of its own largest magnitude plus 1e-7 of the largest
gradient of the tree (the key biases have a true gradient of 0, as the
softmax is shift-invariant, and carry only rounding); optimizer updates
rtol 1e-5 against optax fed the same gradients.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_bwd
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

import efficient_tts_tpu.nn.attention as jattn
from efficient_tts_tpu.losses import fastspeech as jloss
from efficient_tts_tpu.models import efficient_tts_transformer as jt
from efficient_tts_tpu.ops import alignment as jal
from efficient_tts_tpu.train import efts_train_step as jstep
from efficient_tts_tpu.train import optim as joptim
from efficient_tts_tpu.train import schedule as jschedule
from efficient_tts_tpu.train.state import create_state as jcreate_state
from efficient_tts_tpu.utils.config import load_config
from efficient_tts_tpu.utils.config import optimizer_from_dict as joptimizer_from_dict
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.losses.fastspeech import fastspeech_loss
from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
from efficient_tts_tpu_torch.nn.layers import dropout, split_generator
from efficient_tts_tpu_torch.ops import alignment as tal
from efficient_tts_tpu_torch.ops import flash_attention as tfa
from efficient_tts_tpu_torch.train import checkpoint as tckpt
from efficient_tts_tpu_torch.train.efts_train_step import make_eval_step, make_train_step
from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
from efficient_tts_tpu_torch.train.optim import AdamWarmup, optimizer_from_dict
from efficient_tts_tpu_torch.train.schedule import warmup_lr
from efficient_tts_tpu_torch.train.state import create_state
from efficient_tts_tpu_torch.utils import plotting

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = EftsTransformerConfig(num_symbols=40, odim=20, n_channels=32, n_heads=2, ff_hidden=64,
                            n_text_encoder_layer=2, n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0,
                            attn_impl="flash")
TOL = dict(rtol=1e-5, atol=1e-5)
# the yaml's Adam + WarmupLR, with a short warmup so the learning rate is not tiny
ADAM = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-9, weight_decay=1e-5, amsgrad=True, grad_clip_norm=1.0,
            warmup_steps=4)


def _patched_flash(q, k, v, mask, dk):
    seg = None
    if mask is not None:
        ids = mask[:, 0, :].astype(jnp.int32)
        seg = JSegmentIds(q=ids, kv=ids)
    return mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=1.0 / float(np.sqrt(dk)))


@pytest.fixture(autouse=True)
def _jax_flash_on_cpu(monkeypatch):
    monkeypatch.setattr(jattn, "_flash_attention", _patched_flash)


def _jcfg(cfg):
    return jt.EftsTransformerConfig(**dataclasses.asdict(cfg))


def _batch(b=3, t1=128, t2=256, seed=0, text_lengths=(128, 100, 64), mel_lengths=(256, 200, 150)):
    rng = np.random.default_rng(seed)
    tl, ml = np.array(text_lengths[:b], np.int32), np.array(mel_lengths[:b], np.int32)
    text = np.zeros((b, t1), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, CFG.num_symbols, n)
    mel = rng.standard_normal((b, t2, CFG.odim)).astype(np.float32)
    mel *= np.arange(t2)[None, :, None] < ml[:, None, None]
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


@pytest.fixture(scope="module")
def params():
    return init.init_efts_transformer(0, CFG)


def _model(params, cfg=CFG):
    return compat.efts_transformer_from_jax(params, cfg, device="cpu", trainable=True)


def _close(out, ref, **tol):
    out = out.detach().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, np.asarray(ref), **(tol or TOL))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_trees_close(out, ref, rtol=1e-4, gtol=1e-7):
    leaves_r, tree_r = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, ref))
    leaves_o, tree_o = jax.tree_util.tree_flatten(out)
    assert tree_o == tree_r
    gmax = max(float(np.abs(r).max()) for r in leaves_r)
    for o, r in zip(leaves_o, leaves_r):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=0, atol=rtol * float(np.abs(r).max()) + gtol * gmax)


# ---------------------------------------------------------------------------
# the flash backward's plain version


@pytest.mark.parametrize("segmented", [False, True])
def test_flash_backward_reference_matches_the_library(segmented):
    """`flash_attention_bwd_reference` on the plain forward's residuals against
    `jax.grad` of `mha_reference_no_custom_vjp` (sm_scale 1/4) and against the
    library's `mha_reference_bwd` (sm_scale 1, the only scale it takes);
    autograd through `flash_attention_reference` against both; m and l
    against the library's residuals. f32, rtol = atol = 1e-5."""
    b, h, t, dk = 3, 2, 128, 16
    q, k, v, do = (_x((b, h, t, dk), s) for s in range(4))
    seg_j = seg_t = None
    if segmented:
        ids = (np.arange(t)[None, :] < np.array([128, 100, 37])[:, None]).astype(np.int32)
        seg_j = JSegmentIds(q=jnp.asarray(ids), kv=jnp.asarray(ids))
        seg_t = tfa.SegmentIds(torch.from_numpy(ids), torch.from_numpy(ids))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    for scale in (0.25, 1.0):
        o, m, l = tfa.flash_attention_reference(tq, tk, tv, seg_t, scale, return_residuals=True)
        _, l_j, m_j = mha_reference_no_custom_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, seg_j,
                                                  sm_scale=scale, save_residuals=True)
        _close(m, m_j)
        _close(l, l_j)
        got = tfa.flash_attention_bwd_reference(tq, tk, tv, o, m, l, tdo, seg_t, scale)
        _, vjp = jax.vjp(lambda a, b_, c: mha_reference_no_custom_vjp(a, b_, c, segment_ids=seg_j, sm_scale=scale),
                         *(jnp.asarray(a) for a in (q, k, v)))
        ref = vjp(jnp.asarray(do))
        xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        auto = torch.autograd.grad(tfa.flash_attention_reference(*xs, seg_t, scale), xs, tdo)
        for g, a, r in zip(got, auto, ref):
            _close(g, r)
            _close(a, r)
        if scale == 1.0:
            lib = mha_reference_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, seg_j, jnp.asarray(o.numpy()),
                                    jnp.asarray(l.numpy()), jnp.asarray(m.numpy()), jnp.asarray(do))
            for g, r in zip(got, lib[:3]):
                _close(g, r)


def test_flash_attention_differentiates_its_plain_version_on_the_cpu():
    """On CPU tensors the entry point is the plain forward under autograd and
    counts no launch."""
    q, k, v = (torch.from_numpy(_x((1, 2, 64, 8), s)).requires_grad_(True) for s in range(3))
    tfa.reset_launches()
    o = tfa.flash_attention(q, k, v, None, 0.5)
    o.sum().backward()
    assert tfa.launches == {} and q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# alignment ops and the loss


def _vjp_check(fn_t, fn_j, args, ct_seed=9, tol=TOL):
    """Values and the VJP of a random cotangent, port against JAX."""
    out_j, vjp = jax.vjp(fn_j, *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out_t = fn_t(*ts)
    _close(out_t, out_j, **tol)
    ct = _x(out_t.shape, ct_seed)
    grads_t = torch.autograd.grad(out_t, ts, torch.from_numpy(ct))
    for g, r in zip(grads_t, vjp(jnp.asarray(ct))):
        _close(g, r, **tol)


def _masks(b=3, t1=16, t2=40):
    tl = np.array([16, 11, 6])[:b]
    ml = np.array([40, 31, 17])[:b]
    return (np.arange(t1)[None, :] < tl[:, None]), (np.arange(t2)[None, :] < ml[:, None]), tl, ml


def test_scaled_dot_attention_and_index_vector_match_jax():
    tm, _, _, _ = _masks()
    _vjp_check(lambda q, k: tal.scaled_dot_attention(q, k, torch.from_numpy(tm)),
               lambda q, k: jal.scaled_dot_attention(q, k, jnp.asarray(tm)), [_x((3, 40, 8), 1), _x((3, 16, 8), 2)])
    np.testing.assert_array_equal(tal.index_vector(torch.from_numpy(tm)).numpy(),
                                  np.asarray(jal.index_vector(jnp.asarray(tm))))


@pytest.mark.parametrize("plateau", [False, True])
def test_imv_from_alpha_matches_jax(plateau):
    """With `plateau`, alpha is the same column from frame 20 on, so the imv
    diffs are exactly 0 there (max(0, 0) splits its gradient) and imv ends in
    a run of tied maxima (the max spreads its gradient over them)."""
    tm, mm, tl, _ = _masks()
    alpha = np.abs(_x((3, 16, 40), 3))
    alpha /= alpha.sum(axis=1, keepdims=True)
    if plateau:
        alpha[:, :, 20:] = alpha[:, :, 20:21]
    p = (np.arange(16)[None, :] * tm).astype(np.float32)
    _vjp_check(lambda a, pp: tal.imv_from_alpha(a, pp, torch.from_numpy(mm), torch.from_numpy(tl)),
               lambda a, pp: jal.imv_from_alpha(a, pp, jnp.asarray(mm), jnp.asarray(tl)), [alpha, p],
               tol=dict(rtol=1e-5, atol=1e-4))


def test_aligned_positions_and_reconstruction_match_jax():
    tm, mm, tl, _ = _masks()
    imv = np.sort(np.abs(_x((3, 40), 4)) * 5, axis=1).astype(np.float32)
    p = (np.arange(16)[None, :] * tm).astype(np.float32)
    _vjp_check(lambda i, pp: tal.aligned_positions(i, pp, torch.from_numpy(mm), torch.from_numpy(tm), 0.5),
               lambda i, pp: jal.aligned_positions(i, pp, jnp.asarray(mm), jnp.asarray(tm), 0.5), [imv, p],
               tol=dict(rtol=1e-5, atol=1e-4))
    e = np.cumsum(np.abs(_x((3, 16), 5)) * 2, axis=1).astype(np.float32)
    _vjp_check(lambda ee: tal.alignment_from_positions(ee, 40, 0.01, torch.from_numpy(mm), torch.from_numpy(tm)),
               lambda ee: jal.alignment_from_positions(ee, 40, 0.01, jnp.asarray(mm), jnp.asarray(tm)), [e])


@pytest.mark.parametrize("normalize,use_masking,use_mse", [("frame", True, True), ("utterance", True, True),
                                                          ("frame", False, True), ("frame", True, False)])
def test_fastspeech_loss_matches_jax(normalize, use_masking, use_mse):
    tm, mm, _, _ = _masks()
    args = [_x((3, 40, 6), 6), _x((3, 40, 6), 7), _x((3, 16), 8), _x((3, 16), 9)]

    def run(lib, xs, masks):
        return lib(*xs, *masks, use_masking=use_masking, use_mse=use_mse, loss_normalize=normalize)

    ref, vjp = jax.vjp(lambda *xs: run(jloss.fastspeech_loss, xs, (jnp.asarray(tm), jnp.asarray(mm))),
                       *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = run(fastspeech_loss, ts, (torch.from_numpy(tm), torch.from_numpy(mm)))
    for o, r in zip(out, ref):
        _close(o, r)
    grads = torch.autograd.grad(out[0] + 2 * out[1], ts)
    for g, r in zip(grads, vjp((jnp.float32(1.0), jnp.float32(2.0)))):
        _close(g, r)


def test_fastspeech_loss_rejects_an_unknown_normalization():
    x = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="loss_normalize"):
        fastspeech_loss(x, x, x[..., 0], x[..., 0], x[..., 0] > -1, x[..., 0] > -1, loss_normalize="frames")


# ---------------------------------------------------------------------------
# the training forward


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_forward_and_every_gradient_leaf_match_jax(params, impl):
    """Loss, mel and duration losses, imv, reconst_alpha, mel_pred, e and
    every gradient leaf against `jax.value_and_grad` of `forward` (dropout
    off), on a ragged batch, under both attention paths."""
    cfg = dataclasses.replace(CFG, attn_impl=impl)
    batch = _batch()
    jcfg = _jcfg(cfg)

    @jax.jit
    def loss_fn(p):
        out = jt.forward(p, jcfg, *(jnp.asarray(batch[k]) for k in ("text", "text_lengths", "mel", "mel_lengths")),
                         deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = _model(params, cfg)
    out_t = model(*(torch.from_numpy(batch[k]).long() if k != "mel" else torch.from_numpy(batch[k])
                    for k in ("text", "text_lengths", "mel", "mel_lengths")))
    out_t["loss"].backward()
    assert 0.5 < float(out_t["loss"].detach()) < 10
    for key in ("loss", "mel_loss", "duration_loss", "reconst_alpha"):
        _close(out_t[key], out_j[key])
    _close(out_t["mel_pred"], out_j["mel_pred"], rtol=1e-5, atol=5e-5)
    _close(out_t["imv"], out_j["imv"], rtol=1e-5, atol=1e-4)
    _close(out_t["aligned_e"], out_j["aligned_e"], rtol=1e-5, atol=1e-3)
    _assert_trees_close(compat.efts_transformer_to_jax(model, grads=True), grads_j)


def test_inference_model_refuses_to_train_and_both_models_train(params):
    model = compat.efts_transformer_from_jax(params, CFG, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(RuntimeError, match="training_modules"):
        model(*(torch.zeros((1, 128), dtype=torch.long), torch.tensor([4]), torch.zeros((1, 128, 20)),
                torch.tensor([8])))
    assert model_class_for(CFG, training=True).TRAINS
    assert model_class_for(EftsCNNConfig(), training=True) is EftsCNN


def test_bridge_round_trip(params):
    """`efts_transformer_to_jax` inverts `efts_transformer_from_jax` exactly,
    for both feed-forward kinds."""
    for cfg in (CFG, dataclasses.replace(CFG, use_conv_ff=False)):
        p = init.init_efts_transformer(1, cfg)
        _assert_trees_close(compat.efts_transformer_to_jax(_model(p, cfg)), p, rtol=0, gtol=0)


# ---------------------------------------------------------------------------
# optimizer


def test_warmup_lr_matches_jax():
    sched_t, sched_j = warmup_lr(1e-3, 4000), jschedule.warmup_lr(1e-3, 4000)
    for count in (0, 1, 2, 3998, 3999, 4000, 100000):
        assert sched_t(count) == pytest.approx(float(sched_j(count)), rel=1e-6)


@pytest.mark.parametrize("amsgrad,clip_scale", [(True, 1.0), (True, 0.05), (False, 1.0)])
def test_optimizer_matches_optax(amsgrad, clip_scale):
    """Updates of `AdamWarmup` against optax `adam_warmup` fed the same
    gradients for 5 steps. The gradients' scale moves under and over the
    clip norm (clip_scale 0.05: never clipped), and their magnitudes change
    from step to step, so amsgrad's max of the bias-corrected second moment
    takes the old value on some elements (it would differ from the max of
    the raw moment from step 2 on)."""
    kw = dict(ADAM, amsgrad=amsgrad)
    tx_j = joptim.adam_warmup(**kw)
    tx_t = AdamWarmup(**kw)
    rng = np.random.default_rng(0)
    p_np = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    p_t = {n: torch.from_numpy(v.copy()) for n, v in p_np.items()}
    st_j, st_t = tx_j.init(p_np), tx_t.init(p_t)
    for step in range(5):
        scale = clip_scale * (3.0 if step % 2 == 0 else 0.2)
        g_np = {n: (scale * rng.standard_normal(v.shape)).astype(np.float32) for n, v in p_np.items()}
        u_j, st_j = tx_j.update(g_np, st_j, p_np)
        u_t, st_t = tx_t.update({n: torch.from_numpy(g) for n, g in g_np.items()}, st_t, p_t)
        for n in p_np:
            _close(u_t[n], u_j[n], rtol=1e-5, atol=1e-10)
        p_np = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), p_np, u_j)
        p_t = {n: torch.from_numpy(p_np[n].copy()) for n in p_np}
    assert st_t["count"] == 5


def test_optimizer_from_the_yaml_matches_the_jax_config():
    """The transformer yaml's optimizer block gives the same chain: one update
    of the same gradients agrees with optax's; so does the yaml with its
    optimizer set to RAdam (no clip, no schedule, as JAX's branch), over
    steps past RAdam's rectification threshold."""
    config = load_config(os.path.join(ROOT, "efficient_tts_tpu", "configs", "lj_efts_transformer_phnseq.yaml"))
    tx_t, tx_j = optimizer_from_dict(config), joptimizer_from_dict(config)
    assert (tx_t.b1, tx_t.b2, tx_t.eps, tx_t.weight_decay, tx_t.amsgrad, tx_t.grad_clip_norm) == (
        0.9, 0.99, 1e-9, 1e-5, True, 1.0)
    p = {"w": np.ones((4,), np.float32)}
    g = {"w": np.array([0.5, -0.25, 1e-3, 2.0], np.float32)}
    u_j, _ = tx_j.update(g, tx_j.init(p), p)
    u_t, _ = tx_t.update({"w": torch.from_numpy(g["w"])}, tx_t.init({"w": torch.from_numpy(p["w"])}),
                         {"w": torch.from_numpy(p["w"])})
    _close(u_t["w"], u_j["w"], rtol=1e-5, atol=1e-12)
    radam = {**config, "optimizer_type": "RAdam"}
    tx_t, tx_j = optimizer_from_dict(radam), joptimizer_from_dict(radam)
    st_t, st_j = tx_t.init({"w": torch.from_numpy(p["w"])}), tx_j.init(p)
    rng = np.random.default_rng(9)
    for _ in range(8):
        g = {"w": rng.standard_normal(4).astype(np.float32)}
        u_j, st_j = tx_j.update(g, st_j, p)
        u_t, st_t = tx_t.update({"w": torch.from_numpy(g["w"])}, st_t, {"w": torch.from_numpy(p["w"])})
        _close(u_t["w"], u_j["w"], rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# train step, accumulation, dropout, trainer


def test_train_step_matches_jax(params):
    """One `make_train_step` step against JAX's from the same params and
    batch: loss, mel and duration losses and grad_norm (rtol 1e-5); the
    parameter updates (rtol 1e-3) where the decayed, clipped gradient g' is
    well above rounding (|g'| > 1e-3 of its leaf's max): the first update is
    -lr g' / (|g'| + 1e-9), about -lr * sign(g'), which moves or flips under
    rounding where g' is near 0 (clip and weight decay can cancel there)."""
    batch = _batch()
    tx_j = joptim.adam_warmup(**ADAM)
    state_j = jcreate_state(params, tx_j)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_j, metrics_j = jstep.make_train_step(_jcfg(CFG), tx_j)(state_j, jbatch, jax.random.PRNGKey(0))

    def loss_fn(p):
        return jt.forward(p, _jcfg(CFG), *(jbatch[k] for k in ("text", "text_lengths", "mel", "mel_lengths")))["loss"]

    grads_j = jax.jit(jax.grad(loss_fn))(params)
    model = _model(params)
    state = create_state(model, AdamWarmup(**ADAM))
    state, metrics = make_train_step(CFG, AdamWarmup(**ADAM), device="cpu")(state, batch)
    assert state["step"] == 1
    for k in ("loss", "mel_loss", "duration_loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(metrics_j[k]), rel=1e-5)
    after = compat.efts_transformer_to_jax(model)
    flat = zip(*(jax.tree_util.tree_leaves(t) for t in (after, new_j["params"], params, grads_j)))
    clip = min(1.0, 1.0 / float(metrics_j["grad_norm"]))
    n_checked = 0
    for a, nj, p0, g in flat:
        p0, nj = np.asarray(p0, np.float32), np.asarray(nj)
        g_dec = np.asarray(g) * clip + ADAM["weight_decay"] * p0
        sure = np.abs(g_dec) > 1e-3 * np.abs(g_dec).max()
        np.testing.assert_allclose((a - p0)[sure], (nj - p0)[sure], rtol=1e-3, atol=1e-9)
        n_checked += int(sure.sum())
    assert n_checked > 0.8 * sum(np.size(x) for x in jax.tree_util.tree_leaves(params))


def test_gradient_accumulation_matches_the_full_batch(params):
    """accum_steps=2 on a ragged batch of 4 (micro-batches of very different
    valid lengths) against accum_steps=1: the same metrics and, leaf by
    leaf, the same first moment after one step (mu = 0.1 * (clipped g +
    decay * p)), so the same gradient; rtol 1e-4 of each leaf's max."""
    batch = _batch(b=4, text_lengths=(128, 120, 40, 20), mel_lengths=(256, 250, 90, 60))
    cfg = dataclasses.replace(CFG, attn_impl="xla")
    runs = []
    for accum in (1, 2):
        model = _model(params, cfg)
        state = create_state(model, AdamWarmup(**ADAM))
        state, metrics = make_train_step(cfg, AdamWarmup(**ADAM), accum_steps=accum, device="cpu")(state, batch)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: t.numpy() for n, t in state["opt_state"]["mu"].items()}))
    (m1, mu1), (m2, mu2) = runs
    for k in m1:
        assert m2[k] == pytest.approx(m1[k], rel=1e-5)
    _assert_trees_close(mu2, mu1)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(cfg, AdamWarmup(**ADAM), accum_steps=3, device="cpu")(create_state(_model(params, cfg),
                                                                                          AdamWarmup()), batch)


def test_dropout_keeps_one_minus_rate_and_scales():
    x = torch.ones((200, 500))
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, gen, deterministic=False)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.1, None, deterministic=True) is x and dropout(x, 0.0, gen, False) is x
    a = dropout(x, 0.5, torch.Generator().manual_seed(3), False)
    b = dropout(x, 0.5, torch.Generator().manual_seed(3), False)
    assert torch.equal(a, b) and not torch.equal(a, y)
    g1, g2 = split_generator(torch.Generator().manual_seed(1), 2)
    assert not torch.equal(dropout(x, 0.5, g1, False), dropout(x, 0.5, g2, False))
    with pytest.raises(ValueError):
        dropout(x, 0.1, None, deterministic=False)


def test_dropout_training_takes_the_xla_branch(params):
    """With dropout 0.1 no attention call is flash-eligible (as in JAX), the
    step runs with an explicit generator and gives finite metrics, the same
    generator seed gives the same losses, and the step refuses to run
    without a generator."""
    cfg = dataclasses.replace(CFG, dropout_rate=0.1)
    batch = _batch()
    assert not jattn._flash_eligible(128, 128, None, 0.1, False)
    losses = []
    for _ in range(2):
        state = create_state(_model(params, cfg), AdamWarmup(**ADAM))
        step = make_train_step(cfg, AdamWarmup(**ADAM), device="cpu")
        _, metrics = step(state, batch, torch.Generator().manual_seed(5))
        assert all(math.isfinite(float(v)) for v in metrics.values())
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="generator"):
        step(state, batch)


def _batches(n, seed=0):
    batch = _batch(seed=seed)
    for i in range(n):
        yield i // 2, batch


def test_trainer_saves_reloads_and_resumes(params, tmp_path):
    """4 steps in one run against 2 steps, a save, a reload into a fresh
    trainer and 2 more: the same parameters (rtol 1e-6); interval saves,
    pruning, eval, and the checkpoint visible to `latest_checkpoint`."""
    def trainer(outdir, steps):
        t = EftsTrainer(CFG, AdamWarmup(**ADAM), _batches(10), eval_batches=[_batch(seed=1)], outdir=str(outdir),
                        train_max_steps=steps, save_interval_steps=2, eval_interval_steps=2, log_interval_steps=1,
                        max_keep_checkpoints=1, device="cpu")
        t.init_state(_model(params))
        return t

    full = trainer(tmp_path / "full", 4)
    full.run()
    # the evals at steps 2 and 4 draw the JAX trainer's images where matplotlib is installed
    images = ["images"] if plotting.available() else []
    assert sorted(os.listdir(tmp_path / "full")) == ["checkpoint-4steps", *images]
    first = trainer(tmp_path / "split", 2)
    first.run()
    path = tckpt.latest_checkpoint(str(tmp_path / "split"))
    assert path.endswith("checkpoint-2steps")
    second = trainer(tmp_path / "split", 4)
    second.load(path)
    assert second.state["step"] == 2 and second.state["opt_state"]["count"] == 2
    second.run()
    _assert_trees_close(compat.efts_transformer_to_jax(second.state["params"]),
                        compat.efts_transformer_to_jax(full.state["params"]), rtol=1e-6, gtol=0)
    means = second.evaluate(4)
    assert set(means) == {"loss", "mel_loss", "duration_loss", "align_peak"}
    fresh = trainer(tmp_path / "params_only", 4)
    fresh.load(tckpt.latest_checkpoint(str(tmp_path / "full")), load_only_params=True)
    assert fresh.state["step"] == 0 and fresh.state["opt_state"]["count"] == 0


def test_trainer_guards_divergence_and_saves_on_interrupt(params, tmp_path):
    bad = _batch()
    bad["mel"] = np.full_like(bad["mel"], np.nan)

    def nan_batches():
        while True:
            yield 0, bad

    t = EftsTrainer(CFG, AdamWarmup(**ADAM), nan_batches(), outdir=str(tmp_path / "nan"), train_max_steps=3,
                    device="cpu")
    t.init_state(_model(params))
    with pytest.raises(FloatingPointError):
        t.run()
    assert any(n.startswith("diverged-state-") for n in os.listdir(tmp_path / "nan"))
    assert tckpt.latest_checkpoint(str(tmp_path / "nan")) is None

    def interrupted():
        yield 0, _batch()
        raise KeyboardInterrupt

    t = EftsTrainer(CFG, AdamWarmup(**ADAM), interrupted(), outdir=str(tmp_path / "int"), train_max_steps=5,
                    device="cpu")
    t.init_state(_model(params))
    with pytest.raises(KeyboardInterrupt):
        t.run()
    assert tckpt.latest_checkpoint(str(tmp_path / "int")).endswith("checkpoint-1steps")


def test_eval_step_matches_the_forward(params):
    batch = _batch()
    model = _model(params)
    out = make_eval_step(CFG, device="cpu")(model, batch)
    ref = model(*(torch.from_numpy(batch[k]).long() if k != "mel" else torch.from_numpy(batch[k])
                  for k in ("text", "text_lengths", "mel", "mel_lengths")))
    for k in ("loss", "imv", "reconst_alpha", "mel_pred"):
        assert torch.equal(out[k], ref[k].detach())
    assert not out["loss"].requires_grad
