"""Port EFTS-CNN training against the JAX package, on the CPU.

A tiny EFTS-CNN (24 channels, 2 text-encoder, 1 mel-encoder and 2 decoder
res-conv layers of k=5, 20 mel bins, 30 symbols) gets seeded numpy
weights in the JAX tree's layout (`init.init_efts`, weight norm as {v,
g}); the same tree feeds `efficient_tts_tpu/models/efficient_tts.py:
forward` and, through the bridge (`trainable=True`), the port, on a
ragged batch of 3 (T1 = 24, T2 = 64). Dropout is off wherever the two are
compared (the frameworks' random streams differ); its own properties are
tested apart.

Tolerances, f32 on both sides: activations rtol = atol = 1e-5 (1e-4 for
imv and e, which reach tens after cumsums); every gradient leaf, v and g
included, within 1e-4 of its own largest magnitude plus 1e-7 of the
largest gradient of the tree (the key bias's true gradient is 0, as the
softmax is shift-invariant, and carries only rounding). bf16
(`compute_dtype="bfloat16"` on both sides): the losses rtol 1e-3, the mel
prediction atol 1e-2, imv, e and the alignment as in f32 (the chain is
f32), and the error norm of every gradient leaf within 1e-1 of the leaf's
norm plus 1e-3 of the whole gradient's norm: the two frameworks round at
the same points, but a different f32 sum can move a bf16 rounding by one
step, and the steps carry through the convs (seen over three seeds:
losses 1.8e-4, mel 3.4e-3 of a range of 1.3, leaves up to 3.7e-2).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.models import efficient_tts as je
from efficient_tts_tpu.nn.layers import weight_norm_kernel as jweight_norm_kernel
from efficient_tts_tpu.train import efts_train_step as jstep
from efficient_tts_tpu.train.state import create_state as jcreate_state
from efficient_tts_tpu.utils.config import optimizer_from_dict as joptimizer_from_dict
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.models import model_class_for
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig
from efficient_tts_tpu_torch.nn.blocks import ResConvBlock
from efficient_tts_tpu_torch.nn.layers import Conv1d, WNConv1d, leaky_relu
from efficient_tts_tpu_torch.train.efts_train_step import make_train_step
from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
from efficient_tts_tpu_torch.train.state import create_state, named_params
from efficient_tts_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = EftsCNNConfig(num_symbols=30, odim=20, symbol_embedding_dim=24, n_channels=24, n_text_encoder_layer=2,
                    n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0, use_masking=True)
# the module 3 options, two or three at a time: together they set every flag both ways
VARIANTS = {
    "yaml": {},
    "shared_kv_query_fc_utterance": dict(share_text_encoder_key_value=True, use_mel_query_fc=True,
                                         loss_normalize="utterance"),
    "unmasked_plain_convs": dict(use_masking=False, use_weight_norm=False),
}
KEYS = ("text", "text_lengths", "mel", "mel_lengths")
OUT_KEYS = ("loss", "mel_loss", "duration_loss", "imv", "reconst_alpha", "mel_pred", "aligned_e")


def _batch(b=3, t1=24, t2=64, text_lengths=(24, 17, 9), mel_lengths=(64, 45, 30), seed=0):
    rng = np.random.default_rng(seed)
    tl, ml = np.array(text_lengths[:b], np.int32), np.array(mel_lengths[:b], np.int32)
    text = np.zeros((b, t1), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, CFG.num_symbols, n)
    mel = rng.standard_normal((b, t2, CFG.odim)).astype(np.float32)
    mel *= np.arange(t2)[None, :, None] < ml[:, None, None]
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


def _torch_batch(batch):
    return [torch.from_numpy(batch[k]) if k == "mel" else torch.from_numpy(batch[k]).long() for k in KEYS]


def _jcfg(cfg):
    return je.EftsCNNConfig(**dataclasses.asdict(cfg))


def _model(params, cfg=CFG):
    return compat.efts_cnn_from_jax(params, cfg, device="cpu", trainable=True)


def _jax_value_and_grad(params, cfg, batch):
    jcfg = _jcfg(cfg)

    def loss_fn(p):
        out = je.forward(p, jcfg, *(jnp.asarray(batch[k]) for k in KEYS), deterministic=True)
        return out["loss"], out

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _close(out, ref, rtol=1e-5, atol=1e-5):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def _assert_trees_close(out, ref, rtol=1e-4, gtol=1e-7):
    leaves_r, tree_r = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, ref))
    leaves_o, tree_o = jax.tree_util.tree_flatten(out)
    assert tree_o == tree_r
    gmax = max(float(np.abs(r).max()) for r in leaves_r)
    for o, r in zip(leaves_o, leaves_r):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r.astype(np.float32), rtol=0, atol=rtol * float(np.abs(r).max()) + gtol * gmax)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_every_gradient_leaf_match_jax(variant):
    """The seven outputs and every gradient leaf (v and g of each weight-normed
    conv included) against `jax.value_and_grad` of `forward`, f32."""
    cfg = dataclasses.replace(CFG, **VARIANTS[variant])
    params = init.init_efts(0, cfg)
    batch = _batch()
    (_, out_j), grads_j = _jax_value_and_grad(params, cfg, batch)
    model = _model(params, cfg)
    out_t = model(*_torch_batch(batch))
    out_t["loss"].backward()
    assert set(out_t) == set(OUT_KEYS)
    assert 0.5 < float(out_t["loss"].detach()) < 50
    for key in ("loss", "mel_loss", "duration_loss", "reconst_alpha", "mel_pred"):
        _close(out_t[key], out_j[key])
    for key in ("imv", "aligned_e"):
        _close(out_t[key], out_j[key], atol=1e-4)
    grads_t = compat.efts_cnn_to_jax(model, grads=True)
    if cfg.use_weight_norm:
        assert set(grads_t["decoder"]["layers"][0]) == {"v", "g", "b"}
    _assert_trees_close(grads_t, grads_j)


def test_bf16_forward_and_gradients_match_jax():
    """compute_dtype="bfloat16" on both sides, within the bf16 bounds of the
    module docstring; the alignment chain and the losses stay f32."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    params = init.init_efts(0, cfg)
    batch = _batch()
    (_, out_j), grads_j = _jax_value_and_grad(params, cfg, batch)
    model = _model(params, cfg)
    out_t = model(*_torch_batch(batch))
    out_t["loss"].backward()
    for key in ("imv", "aligned_e", "reconst_alpha", "mel_pred"):
        assert out_t[key].dtype == torch.float32
    for key in ("loss", "mel_loss", "duration_loss"):
        _close(out_t[key], out_j[key], rtol=1e-3, atol=0)
    _close(out_t["mel_pred"], out_j["mel_pred"], rtol=0, atol=1e-2)
    _close(out_t["reconst_alpha"], out_j["reconst_alpha"])
    for key in ("imv", "aligned_e"):
        _close(out_t[key], out_j[key], atol=1e-4)
    leaves_t = jax.tree_util.tree_leaves(compat.efts_cnn_to_jax(model, grads=True))
    leaves_j = [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads_j)]
    g_norm = float(np.sqrt(sum(np.square(g).sum() for g in leaves_j)))
    for t, j in zip(leaves_t, leaves_j, strict=True):
        assert np.linalg.norm(t - j) <= 1e-1 * np.linalg.norm(j) + 1e-3 * g_norm


def test_weight_norm_conv_and_its_fold():
    """`WNConv1d.weight` against the JAX `weight_norm_kernel` (rtol 1e-6);
    `fold` equal to the bridge's numpy fold bit for bit, and a plain conv."""
    p = init.init_efts(3, CFG)["decoder"]["layers"][0]
    conv = WNConv1d(CFG.n_channels, CFG.n_channels, CFG.k_size)
    compat._load_entries([(("v",), conv.v, "conv"), (("g",), conv.g, "conv"), (("b",), conv.bias, "same")], p)
    ref = np.transpose(np.asarray(jweight_norm_kernel({k: jnp.asarray(v) for k, v in p.items()})), (2, 1, 0))
    np.testing.assert_allclose(conv.weight().detach().numpy(), ref, rtol=1e-6, atol=1e-7)
    folded = conv.fold()
    assert type(folded) is Conv1d
    inference = compat.efts_cnn_from_jax(init.init_efts(3, CFG), CFG, device="cpu")
    assert torch.equal(folded.weight, inference.decoder.layers[0].weight)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_round_trip_is_exact_and_covers_every_parameter(variant):
    cfg = dataclasses.replace(CFG, **VARIANTS[variant])
    params = init.init_efts(1, cfg)
    model = _model(params, cfg)
    _assert_trees_close(compat.efts_cnn_to_jax(model), params, rtol=0, gtol=0)
    assert len(jax.tree_util.tree_leaves(params)) == len(named_params(model))
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("variant", ["yaml", "shared_kv_query_fc_utterance"])
def test_folded_training_model_infers_as_the_inference_bridge(variant):
    """A training model folded for inference gives the stage-1 positions
    and the decoded mel of `efts_cnn_from_jax`'s inference model bit for
    bit, in f32 and in bf16."""
    cfg = dataclasses.replace(CFG, **VARIANTS[variant])
    params = init.init_efts(2, cfg)
    folded = _model(params, cfg).fold_weight_norm()
    assert not any(isinstance(m, WNConv1d) for m in folded.modules())
    reference = compat.efts_cnn_from_jax(params, cfg, device="cpu")
    text, lengths = _torch_batch(_batch())[:2]
    with torch.no_grad():
        got, want = folded.infer_durations(text, lengths), reference.infer_durations(text, lengths)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for cdt in (None, torch.bfloat16):
            mel_a, _ = folded.infer_decode(got[1], got[0], got[2], 48, compute_dtype=cdt)
            mel_b, _ = reference.infer_decode(want[1], want[0], want[2], 48, compute_dtype=cdt)
            assert torch.equal(mel_a, mel_b)


def test_inference_model_refuses_to_train():
    model = compat.efts_cnn_from_jax(init.init_efts(0, CFG), CFG, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(RuntimeError, match="training_modules"):
        model(*_torch_batch(_batch()))
    assert model_class_for(CFG, training=True) is EftsCNN


# ---------------------------------------------------------------------------
# the train step


def _yaml_optimizer_config():
    """The char yaml's optimizer block, its warmup cut from 4000 to 4 steps so
    the first update is not lost in the parameters' rounding."""
    config = load_config(os.path.join(ROOT, "efficient_tts_tpu_torch", "configs", "lj_efts_cnn_char.yaml"))
    config["scheduler_params"] = {"warmup_steps": 4}
    return config


def test_train_step_matches_jax():
    """One `make_train_step` step against JAX's from the same params and
    batch, under the yaml's Adam (amsgrad, weight decay, grad norm 1):
    the metrics (rtol 1e-5) and the parameter updates (rtol 1e-3) where the
    decayed, clipped gradient is well above rounding (see
    `test_torch_port_training.py:test_train_step_matches_jax`)."""
    params = init.init_efts(0, CFG)
    batch = _batch()
    config = _yaml_optimizer_config()
    tx_j = joptimizer_from_dict(config)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_j, metrics_j = jstep.make_train_step(_jcfg(CFG), tx_j)(jcreate_state(params, tx_j), jbatch,
                                                              jax.random.PRNGKey(0))
    model = _model(params)
    model(*_torch_batch(batch))["loss"].backward()  # the gradient, held against JAX's above
    grads = compat.efts_cnn_to_jax(model, grads=True)
    model.zero_grad(set_to_none=True)
    tx = optimizer_from_dict(config)
    state, metrics = make_train_step(CFG, tx, device="cpu")(create_state(model, tx), batch)
    assert state["step"] == 1
    for k in ("loss", "mel_loss", "duration_loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(metrics_j[k]), rel=1e-5)
    after = compat.efts_cnn_to_jax(model)
    clip = min(1.0, 1.0 / float(metrics_j["grad_norm"]))
    n_checked = 0
    for a, nj, p0, g in zip(*(jax.tree_util.tree_leaves(t) for t in (after, new_j["params"], params, grads))):
        p0, nj = np.asarray(p0, np.float32), np.asarray(nj)
        g_dec = np.asarray(g) * clip + 1e-5 * p0
        sure = np.abs(g_dec) > 1e-3 * np.abs(g_dec).max()
        np.testing.assert_allclose((a - p0)[sure], (nj - p0)[sure], rtol=1e-3, atol=1e-9)
        n_checked += int(sure.sum())
    assert n_checked > 0.8 * sum(np.size(x) for x in jax.tree_util.tree_leaves(params))


def test_gradient_accumulation_matches_the_full_batch():
    """accum_steps=2 on a ragged batch of 4 (micro-batches of very different
    valid lengths) against accum_steps=1: the same metrics (rtol 1e-5) and,
    leaf by leaf, the same first moment after one step, so the same
    gradient (1e-4 of each leaf's max)."""
    params = init.init_efts(0, CFG)
    batch = _batch(b=4, text_lengths=(24, 22, 8, 5), mel_lengths=(64, 60, 20, 12))
    tx_config = _yaml_optimizer_config()
    runs = []
    for accum in (1, 2):
        tx = optimizer_from_dict(tx_config)
        state = create_state(_model(params), tx)
        state, metrics = make_train_step(CFG, tx, accum_steps=accum, device="cpu")(state, batch)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: t.numpy() for n, t in state["opt_state"]["mu"].items()}))
    (m1, mu1), (m2, mu2) = runs
    for k in m1:
        assert m2[k] == pytest.approx(m1[k], rel=1e-5)
    _assert_trees_close(mu2, mu1)


def test_dropout_properties():
    """With dropout (the frameworks' streams differ, so no JAX comparison):
    each res-conv layer adds leaky(conv(x)) kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else 0; the forward with a generator gives the
    same loss for the same seed and another for another seed, and with
    `deterministic=True` the dropout-free loss; the step asks for a
    generator."""
    block = ResConvBlock(1, 16, 5)
    torch.nn.init.normal_(block.layers[0].weight)
    x = torch.randn(8, 200, 16, generator=torch.Generator().manual_seed(0))
    h = leaky_relu(block.layers[0](x))
    delta = block(x, 0.25, torch.Generator().manual_seed(1), deterministic=False) - x
    kept = delta != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(delta[kept], h[kept] / 0.75, rtol=1e-6, atol=1e-6)

    cfg = dataclasses.replace(CFG, dropout_rate=0.3)
    params = init.init_efts(0, cfg)
    batch = _torch_batch(_batch())
    model = _model(params, cfg)

    def loss(seed=None, deterministic=False):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return float(model(*batch, gen=gen, deterministic=deterministic)["loss"].detach())

    assert loss(5) == loss(5) != loss(6)
    assert loss(deterministic=True) == float(_model(params)(*batch)["loss"].detach())
    tx = optimizer_from_dict(_yaml_optimizer_config())
    with pytest.raises(ValueError, match="generator"):
        make_train_step(cfg, tx, device="cpu")(create_state(model, tx), _batch())
