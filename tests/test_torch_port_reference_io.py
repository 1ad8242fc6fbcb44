"""The reference's PyTorch state dicts, read and written by the port, against the JAX package.

`efficient_tts_tpu_torch/compat/torch_export.py` and `torch_import.py`
against `efficient_tts_tpu/compat/torch_export.py` and `torch_import.py`
on the CPU. Weights are the port's seeded numpy init (`init.py`, in the
JAX tree's layout) with every weight-norm g scaled by a seeded factor in
[0.5, 1.5], so that a fold or a g on the wrong axis shows; one tree per
model for the module, bridged into the port (`compat`). EFTS-CNN is tiny
(32 channels; 2, 1 and 2 res-conv layers; 2 duration layers) in the four
settings of `share_text_encoder_key_value` and `use_mel_query_fc`; the
generators narrow (32 initial channels) with ResBlock1 and ResBlock2; the
MPD and MSD at their only (full) widths. The claims:
  * export: the port's state dict of a model equals the JAX exporter's of
    the bridged tree (`compat.*_to_jax`): the same keys, each array
    byte-equal (dtype, shape, bytes), weight-normed and folded (the folded
    trees folded by the bridge's f64 fold, as the port's exporter folds);
  * import: the JAX exporter's state dict through the port's reader, then
    back through the bridge, equals the JAX importer's tree of the same
    dict bit for bit, and the port's export of what it read is the dict
    again, byte for byte; spectral norm's v is checked against torch's
    in-major order and sigma, a transposed conv's g against its input
    channels;
  * the imported EFTS-CNN's inference against JAX's inference on its
    imported tree, with the CNN parity tests' tolerances
    (`test_torch_port_pipeline.py`): e rtol 1e-5 atol 1e-4, the value
    rtol = atol = 1e-5, the alignment rtol 1e-4 atol 1e-5, the mel rtol =
    atol = 1e-4;
  * a folded generator file and the weight-normed one give the same
    inference generator bit for bit; a file mixing folded and weight-normed
    res-conv layers raises, and so does a folded generator file read as a
    trainable one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.compat import torch_export as jexport
from efficient_tts_tpu.compat import torch_import as jimport
from efficient_tts_tpu.models import efficient_tts as je
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu_torch import compat, init
from efficient_tts_tpu_torch.compat import torch_export, torch_import
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.models.hifigan_train import Discriminators
from efficient_tts_tpu_torch.nn.layers import Conv1d, WNConv1d, fold_weight_norm

EFTS_CFG = EftsCNNConfig(num_symbols=30, odim=20, symbol_embedding_dim=32, n_channels=32, n_text_encoder_layer=2,
                         n_mel_encoder_layer=1, n_decoder_layer=2, dropout_rate=0.0, use_masking=True)
EFTS_VARIANTS = {f"shared_{s}_query_fc_{q}": dict(share_text_encoder_key_value=s, use_mel_query_fc=q)
                 for s in (False, True) for q in (False, True)}
VOC_CFGS = {
    "resblock1": HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                               resblock_dilation_sizes=((1, 3), (1, 3))),
    "resblock2": HiFiGANConfig(upsample_initial_channel=32, resblock="2", resblock_kernel_sizes=(3, 5),
                               resblock_dilation_sizes=((1, 2), (2, 6))),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module (Tier-1 runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _scale_g(tree, rng):
    """Every weight-norm g scaled by a seeded factor in [0.5, 1.5], in place."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            tree["g"] = (tree["g"] * rng.uniform(0.5, 1.5, tree["g"].shape)).astype(np.float32)
        for v in tree.values():
            _scale_g(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _scale_g(v, rng)
    return tree


def _assert_same_state_dict(got: dict, want: dict):
    """The same keys, each array byte-equal."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, g.shape, w.dtype, w.shape)
        assert g.tobytes() == w.tobytes(), k


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), path


@pytest.fixture(scope="module")
def efts_trees():
    trees = {}
    for name, kw in EFTS_VARIANTS.items():
        tree = init.init_efts(0, dataclasses.replace(EFTS_CFG, **kw))
        tree["duration_predictor"]["out"]["b"] = np.full((1,), 1.5, np.float32)
        trees[name] = _scale_g(tree, np.random.default_rng(1))
    return trees


def _efts(name, efts_trees):
    cfg = dataclasses.replace(EFTS_CFG, **EFTS_VARIANTS[name])
    return cfg, _jcfg(je.EftsCNNConfig, cfg), compat.efts_cnn_from_jax(efts_trees[name], cfg, device="cpu",
                                                                       trainable=True)


@pytest.mark.parametrize("name", list(EFTS_VARIANTS))
def test_efts_cnn_export_matches_jax(efts_trees, name):
    cfg, jcfg, model = _efts(name, efts_trees)
    _assert_same_state_dict(torch_export.efts_cnn_to_state_dict(model),
                            jexport.efts_cnn_to_state_dict(compat.efts_cnn_to_jax(model), jcfg))
    assert ("text_encoder_value.weight" in torch_export.efts_cnn_to_state_dict(model)) != \
        cfg.share_text_encoder_key_value
    folded_sd = torch_export.efts_cnn_to_state_dict(model, fold=True)
    model.fold_weight_norm()
    assert isinstance(model.decoder.layers[0], Conv1d)
    want = jexport.efts_cnn_to_state_dict(compat.efts_cnn_to_jax(model), jcfg)
    _assert_same_state_dict(torch_export.efts_cnn_to_state_dict(model), want)
    _assert_same_state_dict(folded_sd, want)
    assert "decoder.layers.0.conv.0.weight" in want and "decoder.layers.0.conv.0.weight_v" not in want


@pytest.mark.parametrize("folded", [False, True], ids=["weight_normed", "folded"])
@pytest.mark.parametrize("name", list(EFTS_VARIANTS))
def test_efts_cnn_import_matches_jax_and_round_trips(efts_trees, name, folded):
    cfg, jcfg, _ = _efts(name, efts_trees)
    tree = fold_weight_norm(efts_trees[name]) if folded else efts_trees[name]
    sd = jexport.efts_cnn_to_state_dict(tree, jcfg)
    model = torch_import.efts_cnn_from_state_dict(sd, cfg, device="cpu", trainable=True)
    assert isinstance(model.text_encoder.layers[0], Conv1d if folded else WNConv1d)
    assert model.cfg.use_weight_norm is not folded
    assert all(p.requires_grad for p in model.parameters())
    _assert_same_tree(compat.efts_cnn_to_jax(model), jimport.efts_cnn_from_state_dict(sd, jcfg))
    _assert_same_state_dict(torch_export.efts_cnn_to_state_dict(model), sd)
    # torch tensors, as torch.load gives them, read the same
    as_torch = torch_import.efts_cnn_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                                     device="cpu", trainable=True)
    _assert_same_state_dict(torch_export.efts_cnn_to_state_dict(as_torch), sd)


def test_efts_cnn_import_refuses_a_file_mixing_folded_and_weight_normed_layers(efts_trees):
    name = "shared_False_query_fc_False"
    _, jcfg, _ = _efts(name, efts_trees)
    sd = jexport.efts_cnn_to_state_dict(efts_trees[name], jcfg)
    folded = jexport.efts_cnn_to_state_dict(fold_weight_norm(efts_trees[name]), jcfg)
    for key in ("weight_v", "weight_g"):
        del sd[f"decoder.layers.1.conv.0.{key}"]
    sd["decoder.layers.1.conv.0.weight"] = folded["decoder.layers.1.conv.0.weight"]
    with pytest.raises(ValueError, match="mixes weight-normed"):
        torch_import.efts_cnn_from_state_dict(sd, EFTS_CFG, device="cpu")


def test_imported_efts_cnn_inference_matches_jax(efts_trees):
    """The inference model of a weight-normed file (folded by the reader)
    against JAX's infer_durations / infer_decode on JAX's import of the file."""
    name = "shared_False_query_fc_False"
    cfg, jcfg, _ = _efts(name, efts_trees)
    sd = jexport.efts_cnn_to_state_dict(efts_trees[name], jcfg)
    model = torch_import.efts_cnn_from_state_dict(sd, cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    jtree = jimport.efts_cnn_from_state_dict(sd, jcfg)
    rng = np.random.default_rng(0)
    lengths = np.array([14, 9, 5], np.int32)
    text = np.zeros((3, 14), np.int32)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.integers(1, cfg.num_symbols, n)
    e_j, v_j, tm_j = je.infer_durations(jtree, jcfg, jnp.asarray(text), jnp.asarray(lengths))
    mel_j, alpha_j = je.infer_decode(jtree, jcfg, v_j, e_j, tm_j, 64)
    with torch.no_grad():
        e_t, v_t, tm_t = model.infer_durations(torch.from_numpy(text).long(), torch.from_numpy(lengths).long())
        mel_t, alpha_t = model.infer_decode(v_t, e_t, tm_t, 64)
    assert float(e_t.max()) > 10  # durations are not degenerate
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def generators():
    out = {}
    for name, cfg in VOC_CFGS.items():
        tree = _scale_g(init.init_generator(2, cfg), np.random.default_rng(3))
        out[name] = (cfg, _jcfg(JHiFiGANConfig, cfg), compat.generator_from_jax(tree, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(VOC_CFGS))
def test_generator_export_matches_jax(generators, name):
    cfg, jcfg, gen = generators[name]
    tree = compat.generator_to_jax(gen)
    _assert_same_state_dict(torch_export.hifigan_generator_to_state_dict(gen),
                            jexport.hifigan_generator_to_state_dict(tree, jcfg))
    folded = torch_export.hifigan_generator_to_state_dict(gen, fold=True)
    _assert_same_state_dict(folded, jexport.hifigan_generator_to_state_dict(fold_weight_norm(tree), jcfg))
    assert "ups.0.weight" in folded and not any(k.endswith("weight_v") for k in folded)


@pytest.mark.parametrize("name", list(VOC_CFGS))
def test_generator_import_matches_jax_and_round_trips(generators, name):
    cfg, jcfg, gen = generators[name]
    sd = jexport.hifigan_generator_to_state_dict(compat.generator_to_jax(gen), jcfg)
    got = torch_import.hifigan_train_generator_from_state_dict(sd, cfg, device="cpu")
    _assert_same_tree(compat.generator_to_jax(got), jimport.hifigan_generator_from_state_dict(sd, jcfg))
    _assert_same_state_dict(torch_export.hifigan_generator_to_state_dict(got), sd)
    # a transposed conv's weight norm is per input channel: g [in, 1, 1]
    c0 = cfg.upsample_initial_channel
    assert got.ups[0].g.shape == (c0, 1, 1) and got.ups[0].v.shape[0] == c0 != got.ups[0].v.shape[1]
    np.testing.assert_array_equal(got.ups[0].g.detach().numpy(), sd["ups.0.weight_g"])
    assert all(p.requires_grad for p in got.parameters())


@pytest.mark.parametrize("name", list(VOC_CFGS))
def test_folded_generator_file_loads_the_same_inference_generator(generators, name):
    cfg, jcfg, gen = generators[name]
    sd = torch_export.hifigan_generator_to_state_dict(gen)
    folded = torch_export.hifigan_generator_to_state_dict(gen, fold=True)
    want = gen.fold(device="cpu").state_dict()
    for state in (sd, folded):
        got = torch_import.hifigan_generator_from_state_dict(state, cfg, device="cpu").state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    jax_folded = compat.hifigan_generator_from_jax(jimport.hifigan_generator_from_state_dict(folded, jcfg), cfg,
                                                   device="cpu").state_dict()
    assert all(torch.equal(jax_folded[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="holds no weight norm to train"):
        torch_import.hifigan_train_generator_from_state_dict(folded, cfg, device="cpu")


class _NoMoments:
    """An optimizer without state: the bridge's GAN state without Adam's
    moments (the discriminators' would double the memory)."""

    def init(self, params):
        return {}


@pytest.fixture(scope="module")
def gan_state():
    cfg = VOC_CFGS["resblock1"]
    tree = init.init_gan_state(4, cfg)
    _scale_g(tree, np.random.default_rng(5))
    tree["step"] = 1234
    state = compat.gan_state_from_jax(tree, cfg, _NoMoments(), _NoMoments(), device="cpu")
    return cfg, state, compat.gan_state_to_jax(state)


def test_discriminator_export_matches_jax(gan_state):
    _, state, tree = gan_state
    disc = state["disc"]["params"]
    _assert_same_state_dict(torch_export.hifigan_mpd_to_state_dict(disc.mpd),
                            jexport.hifigan_mpd_to_state_dict(tree["disc"]["params"]["mpd"]))
    _assert_same_state_dict(torch_export.hifigan_msd_to_state_dict(disc.msd),
                            jexport.hifigan_msd_to_state_dict(tree["disc"]["params"]["msd"]))


@pytest.mark.parametrize("fold", [False, True], ids=["weight_normed", "folded"])
def test_gan_state_to_torch_checkpoints_matches_jax(gan_state, fold):
    cfg, state, tree = gan_state
    g, do = torch_export.gan_state_to_torch_checkpoints(state, fold=fold)
    jtree = {**tree, "gen": {"params": fold_weight_norm(tree["gen"]["params"]) if fold else tree["gen"]["params"]}}
    jg, jdo = jexport.gan_state_to_torch_checkpoints(jtree, _jcfg(JHiFiGANConfig, cfg))
    assert sorted(g) == ["generator"] and sorted(do) == sorted(jdo) == ["epoch", "mpd", "msd", "steps"]
    _assert_same_state_dict(g["generator"], jg["generator"])
    _assert_same_state_dict(do["mpd"], jdo["mpd"])
    _assert_same_state_dict(do["msd"], jdo["msd"])
    assert (do["steps"], do["epoch"]) == (jdo["steps"], jdo["epoch"]) == (1234, 0)


def test_discriminator_import_matches_jax_and_round_trips(gan_state):
    _, state, tree = gan_state
    mpd_sd = jexport.hifigan_mpd_to_state_dict(tree["disc"]["params"]["mpd"])
    msd_sd = jexport.hifigan_msd_to_state_dict(tree["disc"]["params"]["msd"])
    disc = Discriminators()
    disc.mpd = torch_import.hifigan_mpd_from_state_dict(mpd_sd, device="cpu")
    disc.msd = torch_import.hifigan_msd_from_state_dict(msd_sd, device="cpu")
    got = compat.gan_state_to_jax({"gen": state["gen"], "disc": {"params": disc}, "step": 0})["disc"]["params"]
    _assert_same_tree(got["mpd"], jimport.hifigan_mpd_from_state_dict(mpd_sd))
    _assert_same_tree(got["msd"], jimport.hifigan_msd_from_state_dict(msd_sd))
    _assert_same_state_dict(torch_export.hifigan_mpd_to_state_dict(disc.mpd), mpd_sd)
    _assert_same_state_dict(torch_export.hifigan_msd_to_state_dict(disc.msd), msd_sd)
    # spectral norm's v: torch's in-major [in * k] against the port's tap-major
    # [k * in]; sigma = u . (W v) is the same under either flattening (in f64:
    # with the init's random u and v it is a sum with heavy cancellation)
    for j, conv in enumerate(disc.msd.discriminators[0].convs):
        prefix = f"discriminators.0.convs.{j}"
        w, u, v = (msd_sd[f"{prefix}.{n}"] for n in ("weight_orig", "weight_u", "weight_v"))
        out_ch, in_ch, k = w.shape
        np.testing.assert_array_equal(conv.v.numpy(), v.reshape(in_ch, k).T.ravel())
        np.testing.assert_array_equal(conv.u.numpy(), u)
        torch_sigma = np.dot(u.astype(np.float64), w.reshape(out_ch, -1).astype(np.float64) @ v)
        port_sigma = torch.dot(conv.u.double(), conv.matrix().detach().double() @ conv.v.double())
        np.testing.assert_allclose(float(port_sigma), torch_sigma, rtol=1e-9)
    assert all(p.requires_grad for p in disc.parameters())
