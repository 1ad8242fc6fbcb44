"""The port's optimizer and scheduler registry against the JAX package's and torch.optim's, on the CPU.

Every case of `tests/test_optim_registry.py`'s OPT_CASES and SCHED_CASES:
each registry optimizer (`train/torch_optim.py`) runs that file's 7 steps
of seeded gradients beside JAX's optax transformation and torch.optim
itself, and each schedule gives its first 10 learning rates beside JAX's
and those torch's scheduler hands the optimizer, at that file's tolerances
(rtol 2e-5, atol 2e-6 for parameters; rtol 1e-5, atol 1e-7 for learning
rates). Also: `RAdam` against JAX's `radam` (past its rectification
threshold, with and without weight decay);
`optimizer_from_dict` on AdamW + StepLR against JAX's chain and torch, a
grad-norm clip, and unknown names; a checkpoint of a stateful optimizer
(NAdam, centered RMSprop with momentum) that continues its trajectory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_tts_tpu.train.optim import radam as jradam
from efficient_tts_tpu.train.torch_optim import OPTIMIZER_FACTORIES as JOPT
from efficient_tts_tpu.train.torch_optim import SCHEDULER_FACTORIES as JSCHED
from efficient_tts_tpu.utils.config import optimizer_from_dict as joptimizer_from_dict
from efficient_tts_tpu_torch.train import checkpoint
from efficient_tts_tpu_torch.train.optim import OPTIMIZER_REGISTRY, RAdam, optimizer_from_dict
from efficient_tts_tpu_torch.train.torch_optim import OPTIMIZER_FACTORIES, SCHEDULER_FACTORIES
from tests.test_optim_registry import OPT_CASES, SCHED_CASES, _problem, _run_ours, _run_torch

PARAM_TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """PyTorch at two intra-op threads for this module (Tier-1 runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_port(tx, params, grads):
    """The port's optimizer over the steps: named tensors, updates added."""
    p = {f"p{i}": torch.from_numpy(x.copy()) for i, x in enumerate(params)}
    state = tx.init(p)
    for step_grads in grads:
        updates, state = tx.update({f"p{i}": torch.from_numpy(g) for i, g in enumerate(step_grads)}, state, p)
        p = {n: p[n] + updates[n] for n in p}
    return [p[f"p{i}"].numpy() for i in range(len(params))]


def _close_all(got, want, **tol):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("name,kwargs", OPT_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPT_CASES)])
def test_optimizer_matches_jax_and_torch(name, kwargs):
    params, grads = _problem()
    got = _run_port(OPTIMIZER_FACTORIES[name](**kwargs), params, grads)
    _close_all(got, _run_ours(JOPT[name](**kwargs), params, grads), **PARAM_TOL)
    _close_all(got, _run_torch(name, kwargs, params, grads), **PARAM_TOL)


@pytest.mark.parametrize("name,kwargs", SCHED_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHED_CASES)])
def test_scheduler_matches_jax_and_torch(name, kwargs):
    base_lr = 0.1
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.SGD([p], lr=base_lr)
    sched = getattr(torch.optim.lr_scheduler, name)(opt, **kwargs)
    ref = []
    for _ in range(10):
        ref.append(opt.param_groups[0]["lr"])
        p.grad = torch.zeros(1)
        opt.step()
        sched.step()
    got = [SCHEDULER_FACTORIES[name](base_lr, **kwargs)(c) for c in range(10)]
    jax_lrs = [float(JSCHED[name](base_lr, **kwargs)(jnp.asarray(c, jnp.int32))) for c in range(10)]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, jax_lrs, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_matches_jax(weight_decay):
    """14 steps: the first 5 take the bias-corrected momentum alone (the
    variance's length is below 5), the rest the rectified step. The oracle
    is optax's, not torch.optim.RAdam: optax computes the length in f32,
    where it cancels two terms near 2000, and torch in double; the two
    trajectories part by 1.4e-5 here."""
    params, grads = _problem(seed=2)
    grads = grads + grads
    got = _run_port(RAdam(lr=1e-2, weight_decay=weight_decay), params, grads)
    _close_all(got, _run_ours(jradam(lr=1e-2, weight_decay=weight_decay), params, grads), **PARAM_TOL)
    assert set(OPTIMIZER_REGISTRY) == {"Adam", "RAdam", "HiFiGANAdam"}
    cfg = {"optimizer_type": "RAdam", "optimizer_params": {"lr": 1e-2, "weight_decay": weight_decay}}
    _close_all(_run_port(optimizer_from_dict(cfg), params, grads), _run_ours(joptimizer_from_dict(cfg), params, grads),
               **PARAM_TOL)


def test_config_resolves_any_torch_pairing():
    """AdamW + StepLR: the port's chain against JAX's chain and torch."""
    params, grads = _problem(seed=1)
    config = {"optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-2, "weight_decay": 1e-2},
              "scheduler_type": "StepLR", "scheduler_params": {"step_size": 2, "gamma": 0.5}, "grad_norm": None}
    got = _run_port(optimizer_from_dict(config), params, grads)
    _close_all(got, _run_ours(joptimizer_from_dict(config), params, grads), **PARAM_TOL)
    _close_all(got, _run_torch("AdamW", dict(lr=1e-2, weight_decay=1e-2), params, grads, sched="StepLR",
                               sched_kwargs=dict(step_size=2, gamma=0.5)), **PARAM_TOL)


def test_config_grad_norm_clip_and_unknown_names():
    """The clip comes first, as in JAX's chain (a clipped step equals JAX's);
    unknown optimizer and scheduler names raise ValueError."""
    params, grads = _problem(seed=3)
    grads = [[100.0 * g for g in gs] for gs in grads]
    config = {"optimizer_type": "RMSprop", "optimizer_params": {"lr": 1e-2, "momentum": 0.9},
              "scheduler_type": "CosineAnnealingLR", "scheduler_params": {"T_max": 5}, "grad_norm": 1e-3}
    _close_all(_run_port(optimizer_from_dict(config), params, grads),
               _run_ours(joptimizer_from_dict(config), params, grads), **PARAM_TOL)
    sgd = optimizer_from_dict({"optimizer_type": "SGD", "optimizer_params": {"lr": 1.0}, "scheduler_type": "none",
                               "grad_norm": 1e-3})
    p = {"w": torch.ones(3)}
    updates, _ = sgd.update({"w": torch.full((3,), 100.0)}, sgd.init(p), p)
    assert float(torch.linalg.vector_norm(updates["w"])) <= 1e-3 + 1e-9
    with pytest.raises(ValueError, match="unknown optimizer_type"):
        optimizer_from_dict({"optimizer_type": "LBFGS"})
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        optimizer_from_dict({"optimizer_type": "SGD", "scheduler_type": "ReduceLROnPlateau"})


@pytest.mark.parametrize("config", [
    {"optimizer_type": "NAdam", "optimizer_params": {"lr": 2e-3, "weight_decay": 1e-2}, "scheduler_type": "none"},
    {"optimizer_type": "RMSprop", "optimizer_params": {"lr": 1e-2, "momentum": 0.9, "centered": True},
     "scheduler_type": "ExponentialLR", "scheduler_params": {"gamma": 0.9}},
], ids=["NAdam", "RMSprop-centered"])
def test_checkpoint_continues_the_trajectory(config, tmp_path):
    """4 steps, a save through `train/checkpoint.py`, a restore into a fresh
    state, 3 more steps: bit-equal to 7 steps without the break."""
    params, grads = _problem(seed=4)
    tx = optimizer_from_dict(config)

    def fresh():
        module = torch.nn.Module()
        for i, x in enumerate(params):
            module.register_parameter(f"p{i}", torch.nn.Parameter(torch.from_numpy(x.copy())))
        return {"params": module, "opt_state": tx.init(dict(module.named_parameters())), "step": 0}

    def run(state, steps):
        named = dict(state["params"].named_parameters())
        with torch.no_grad():
            for step_grads in steps:
                updates, state["opt_state"] = tx.update(
                    {f"p{i}": torch.from_numpy(g) for i, g in enumerate(step_grads)}, state["opt_state"], named)
                for n, u in updates.items():
                    named[n].add_(u)
                state["step"] += 1
        return state

    whole = run(fresh(), grads)
    path = checkpoint.save_checkpoint(str(tmp_path), run(fresh(), grads[:4]))
    resumed = checkpoint.load_checkpoint(path, fresh())
    assert resumed["step"] == 4
    resumed = run(resumed, grads[4:])
    for (n, a), (_, b) in zip(whole["params"].named_parameters(), resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
