"""The fused optimizer kernels against the per-tensor path, on the card.

Marked `cuda`: skips on a host without an NVIDIA card (the CPU tests in
`test_torch_port_fused_adam.py` hold the path choice and the leaf table).
Over the leaf shapes of both recipes' acoustic models (EFTS-Transformer:
186 leaves, 42.6M parameters; EFTS-CNN: 61 leaves, 20.6M; the tiny and
odd-length ones included), `train/state.py:apply_updates` on the fused path
and `AdamWarmup.update` plus `add_` run 6 steps from the same state on the
same gradients: the parameters and every moment are bit-equal after each
step, given the same norm (the one the caller passed, or the fused norm,
which is within 2e-6 of the per-tensor `global_norm` and repeats exactly).
Cases: amsgrad on and off (and `HiFiGANAdam`), weight decay on and off,
the clip engaged and not, the norm passed in (as the tp step passes it)
and computed. A checkpoint taken mid-way continues bit-equal. A leaf that
is not contiguous (a gradient, a parameter or a moment) is copied for the
launch, counted, and updated bit-equal in place; leaves of another dtype,
shape or device raise instead of leaving the card's path.
"""

from pathlib import Path

import pytest
import torch

from efficient_tts_tpu_torch.ops import fused_adam
from efficient_tts_tpu_torch.train import checkpoint
from efficient_tts_tpu_torch.train.optim import AdamWarmup, HiFiGANAdam, global_norm, grad_norm
from efficient_tts_tpu_torch.train.state import apply_updates, create_state, named_params

pytestmark = pytest.mark.cuda

CONFIGS = {"transformer": "lj_efts_transformer_phnseq.yaml", "cnn": "lj_efts_cnn_char.yaml"}

TX = {
    "recipe": lambda: AdamWarmup(weight_decay=1e-5, amsgrad=True, grad_clip_norm=1.0, warmup_steps=4000),
    "nodecay": lambda: AdamWarmup(weight_decay=0.0, amsgrad=True, grad_clip_norm=1.0, warmup_steps=4000),
    "noamsgrad": lambda: AdamWarmup(weight_decay=1e-5, amsgrad=False, grad_clip_norm=1.0, warmup_steps=4000),
    "hifigan": HiFiGANAdam,
}
# the gradients' global norm at each step: above max_norm = 1 (the clip
# engaged) or below; the rises and falls make amsgrad's max bind
NORMS = {"clipped": (3.0, 1.5, 5.0, 2.0, 4.0, 1.2), "unclipped": (0.9, 0.2, 0.5, 0.05, 0.7, 0.3)}
CASES = [
    ("transformer", "recipe", "clipped", "computed"),
    ("transformer", "recipe", "unclipped", "computed"),
    ("transformer", "recipe", "clipped", "passed"),
    ("transformer", "nodecay", "clipped", "computed"),
    ("transformer", "noamsgrad", "unclipped", "passed"),
    ("transformer", "hifigan", "unclipped", "computed"),
    ("cnn", "recipe", "clipped", "computed"),
    ("cnn", "recipe", "unclipped", "passed"),
    ("cnn", "nodecay", "unclipped", "computed"),
    ("cnn", "noamsgrad", "clipped", "computed"),
    ("cnn", "hifigan", "clipped", "passed"),
]


def leaf_shapes(model: str) -> list:
    """The trainable leaves' shapes of the recipe's model (`configs/`), in its order."""
    from efficient_tts_tpu_torch.models import model_class_for
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict

    configs = Path(__file__).resolve().parents[1] / "efficient_tts_tpu_torch" / "configs"
    cfg = model_config_from_dict(load_config(str(configs / CONFIGS[model])))
    with torch.device("meta"):
        net = model_class_for(cfg, training=True)(cfg, training_modules=True)
    return [tuple(p.shape) for p in net.parameters()]


class Leaves(torch.nn.Module):
    """Parameters of `shapes`, N(0, 0.01) from `seed`, on `device`."""

    def __init__(self, shapes, device, seed: int = 0):
        super().__init__()
        g = torch.Generator(device=device).manual_seed(seed)
        self.ps = torch.nn.ParameterList(torch.nn.Parameter(0.1 * torch.randn(s, generator=g, device=device))
                                         for s in shapes)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def gradients(names, shapes, norm, step, device) -> dict:
    """Seeded gradients whose global norm is about `norm`, each leaf at its own scale."""
    g = torch.Generator(device=device).manual_seed(1000 + step)
    grads = {n: torch.randn(s, generator=g, device=device) * (1.0 + (i % 7)) for i, (n, s) in
             enumerate(zip(names, shapes))}
    total = float(global_norm(list(grads.values())))
    return {n: x * (norm / total) for n, x in grads.items()}


def moments(opt) -> dict:
    return {k: opt[k] for k in ("mu", "nu", "nu_max") if k in opt}


def assert_bit_equal(got: dict, want: dict, what: str):
    for n, w in want.items():
        x = got[n].detach()
        if not torch.equal(x, w):
            diff = (x - w).abs()
            raise AssertionError(f"{what} {n}: {int((diff > 0).sum())} of {w.numel()} elements differ, "
                                 f"the largest by {float(diff.max()):.3e}")


def reference_step(tx, grads, opt, params, norm):
    """The per-tensor path of `apply_updates`."""
    updates, opt = tx.update(grads, opt, params, norm=norm)
    for n, u in updates.items():
        params[n].add_(u)
    return opt


def expected_launches(n_leaves: int, norm_launched: bool) -> dict:
    groups = len(fused_adam.plan([1] * n_leaves, fused_adam.max_leaves()))
    return {"update": groups, **({"norm": groups + 1} if norm_launched else {})}


@pytest.mark.parametrize("model,tx_name,clip,norm_source", CASES, ids=["-".join(c) for c in CASES])
def test_fused_update_matches_per_tensor_path(device, model, tx_name, clip, norm_source):
    shapes = leaf_shapes(model)
    tx = TX[tx_name]()
    state = create_state(Leaves(shapes, device, seed=7), tx)
    names = list(named_params(state["params"]))
    assert len(names) == {"transformer": 186, "cnn": 61}[model]
    ref = {n: p.detach().clone() for n, p in named_params(state["params"]).items()}
    ref_opt = tx.init(ref)
    for step, target in enumerate(NORMS[clip]):
        grads = gradients(names, shapes, target, step, device)
        plain = global_norm(list(grads.values()))
        fused = grad_norm(grads)
        assert torch.equal(fused, grad_norm(grads)), "the fused norm does not repeat"
        assert abs(float(fused) - float(plain)) <= 2e-6 * float(plain), (float(fused), float(plain))
        passed = plain if norm_source == "passed" else None
        fused_adam.reset_launches()
        apply_updates(state, grads, tx, passed)
        assert fused_adam.launches == expected_launches(
            len(names), tx.grad_clip_norm is not None and passed is None)
        assert fused_adam.copied_leaves == {}
        ref_opt = reference_step(tx, grads, ref_opt, ref, plain if passed is not None else fused)
        assert_bit_equal(named_params(state["params"]), ref, f"step {step} parameter")
        for key, leaves in moments(ref_opt).items():
            assert_bit_equal(state["opt_state"][key], leaves, f"step {step} {key}")
        assert state["opt_state"]["count"] == ref_opt["count"] == step + 1
    torch.cuda.synchronize(device)


def test_fused_update_resumes_bit_equal_from_a_checkpoint(device, tmp_path):
    shapes = leaf_shapes("cnn")
    tx = TX["recipe"]()
    state = create_state(Leaves(shapes, device, seed=3), tx)
    names = list(named_params(state["params"]))
    for step in range(3):
        apply_updates(state, gradients(names, shapes, NORMS["clipped"][step], step, device), tx)
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    resumed = checkpoint.load_checkpoint(path, create_state(Leaves(shapes, device, seed=4), tx))
    assert resumed["step"] == 3 and resumed["opt_state"]["count"] == 3
    fused_adam.reset_launches()
    for step in range(3, 6):
        grads = gradients(names, shapes, NORMS["clipped"][step], step, device)
        apply_updates(state, grads, tx)
        apply_updates(resumed, grads, tx)
    assert fused_adam.launches == {k: 6 * v for k, v in expected_launches(len(names), True).items()}
    want = {n: p.detach() for n, p in named_params(state["params"]).items()}
    assert_bit_equal(named_params(resumed["params"]), want, "parameter")
    for key, leaves in moments(state["opt_state"]).items():
        assert_bit_equal(resumed["opt_state"][key], leaves, key)


def strided(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a tensor that is not contiguous."""
    return t.transpose(0, -1).contiguous().transpose(0, -1)


@pytest.mark.parametrize("where", ["gradient", "parameter", "nu_max"])
def test_a_non_contiguous_leaf_is_copied_and_updated_in_place(device, where):
    shapes = leaf_shapes("cnn")
    tx = TX["recipe"]()
    model = Leaves(shapes, device, seed=5)
    names = [f"ps.{i}" for i in range(len(shapes))]
    wide = names[next(i for i, s in enumerate(shapes) if len(s) == 3)]
    if where == "parameter":
        i = names.index(wide)
        model.ps[i] = torch.nn.Parameter(strided(model.ps[i].detach()))
    state = create_state(model, tx)
    if where == "nu_max":
        state["opt_state"]["nu_max"][wide] = strided(state["opt_state"]["nu_max"][wide] + 1e-3)
    ref = {n: p.detach().clone() for n, p in named_params(state["params"]).items()}
    ref_opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
               for k, v in state["opt_state"].items()}
    held = {"parameter": named_params(state["params"])[wide], "nu_max": state["opt_state"]["nu_max"][wide]}
    fused_adam.reset_launches()
    for step in range(2):
        grads = gradients(names, shapes, NORMS["clipped"][step], step, device)
        if where == "gradient":
            grads[wide] = strided(grads[wide])
        assert not (grads[wide] if where == "gradient" else held[where]).is_contiguous()
        norm = grad_norm(grads)
        apply_updates(state, grads, tx, norm)
        ref_opt = reference_step(tx, grads, ref_opt, ref, norm)
    assert fused_adam.launches == {k: 2 * v for k, v in expected_launches(len(names), True).items()}
    assert fused_adam.copied_leaves == ({"norm": 2, "update": 2} if where == "gradient" else {"update": 2})
    if where != "gradient":  # the same tensor, written through its copy
        now = named_params(state["params"])[wide] if where == "parameter" else state["opt_state"]["nu_max"][wide]
        assert now is held[where] and not now.is_contiguous()
    assert_bit_equal(named_params(state["params"]), ref, "parameter")
    for key, leaves in moments(ref_opt).items():
        assert_bit_equal(state["opt_state"][key], leaves, key)


@pytest.mark.parametrize("fault", ["dtype", "shape", "device"])
def test_leaves_the_kernels_cannot_take_raise(device, fault):
    shapes = leaf_shapes("cnn")
    tx = TX["recipe"]()
    state = create_state(Leaves(shapes, device, seed=6), tx)
    names = list(named_params(state["params"]))
    before = {n: p.detach().clone() for n, p in named_params(state["params"]).items()}
    grads = gradients(names, shapes, 2.0, 0, device)
    last = names[-1]
    grads[last] = {"dtype": grads[last].double(), "shape": grads[last].reshape(-1)[:-1],
                   "device": grads[last].cpu()}[fault]
    fused_adam.reset_launches()
    with pytest.raises(ValueError, match="fused optimizer"):
        apply_updates(state, grads, tx, torch.ones((), device=device))
    if fault != "shape":  # the norm alone reads no parameter to hold a shape against
        with pytest.raises(ValueError, match="fused optimizer"):
            grad_norm(grads)
    assert fused_adam.launches == {} and state["step"] == 0 and state["opt_state"]["count"] == 0
    assert_bit_equal(named_params(state["params"]), before, "parameter")
