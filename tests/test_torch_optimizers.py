"""The first-order optimizers of pydens_tpu_torch.utils.optimizers against
the optax transforms that pydens_tpu's registry builds for the same names
and kwargs: 20 updates of a seeded flat vector with their defaults and
with a schedule, the guard's gate, the registry's own defaults, and two
w5 fits on a fixed batch against pydens_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.utils.optimizers import resolve_optimizer as jresolve
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils import optimizers as topt
from pydens_tpu_torch.utils import schedules
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

# (name, torch-style kwargs) as users pass them to fit: each optimizer with
# the registry's defaults, and the options that change its update.
CASES = [
    ("Adam", {}), ("AdamW", {}), ("AdamW", {"weight_decay": 0.05}),
    ("Adamax", {}), ("NAdam", {}), ("RAdam", {}),
    ("SGD", {}), ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {}), ("RMSprop", {"centered": True, "momentum": 0.5}),
    ("Adagrad", {}), ("Adadelta", {}), ("Lion", {}),
]
IDS = [f"{n}-{'-'.join(sorted(k)) or 'defaults'}" for n, k in CASES]
SIZE, STEPS = 257, 20


def _grads():
    """20 seeded gradients of mixed scales, with exact zeros (Adagrad's
    branch) and a late sign flip."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(STEPS):
        g = rng.normal(scale=10.0 ** rng.uniform(-3, 1), size=SIZE)
        g[rng.uniform(size=SIZE) < 0.05] = 0.0
        out.append((g * (-1 if k == 13 else 1)).astype(np.float32))
    return out


def _run_pair(name, kwargs, lr_port, lr_jax):
    theta0 = np.random.default_rng(1).normal(size=SIZE).astype(np.float32)
    jopt, _ = jresolve(name, lr_jax, dict(kwargs))
    jtheta = jnp.asarray(theta0.copy())
    jstate = jopt.init(jtheta)
    # Jitted, as pydens_tpu's step runs it (optax's eager ops round the
    # power b2 ** count differently).
    jupdate = jax.jit(jopt.update)
    opt = resolve_optimizer(name, lr_port, kwargs)
    theta = torch.from_numpy(theta0.copy())
    state = opt.init(theta)
    for g in _grads():
        upd, jstate = jupdate(jnp.asarray(g), jstate, jtheta)
        jtheta = optax.apply_updates(jtheta, upd)
        opt.update(theta, torch.from_numpy(g), state)
    return theta.numpy(), np.asarray(jtheta), state


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_optimizer_matches_optax(name, kwargs):
    # 20 updates at lr 0.01 (Adadelta, which scales by its own ratio, at
    # lr 1): theta agrees to 1e-6 absolute (a step moves it by ~lr; the two
    # differ only in f32 rounding and sqrt/rsqrt's last bit).
    lr = 1.0 if name == "Adadelta" else 0.01
    theta, jtheta, state = _run_pair(name, kwargs, lr, lr)
    assert int(state["count"]) == STEPS
    np.testing.assert_allclose(theta, jtheta, rtol=0, atol=1e-6)
    assert np.abs(theta - np.random.default_rng(1).normal(
        size=SIZE).astype(np.float32)).max() > 10 * lr * 1e-3


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_optimizer_with_a_schedule_matches_optax(name, kwargs):
    # The same 20 updates with a warmup-cosine schedule (the port's and
    # optax's): the schedule is read at the count before each update.
    args = (0.0, 0.02, 5, 20)
    theta, jtheta, _ = _run_pair(
        name, kwargs, schedules.warmup_cosine_decay_schedule(*args),
        optax.warmup_cosine_decay_schedule(*args))
    np.testing.assert_allclose(theta, jtheta, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_closed_gate_changes_nothing(name, kwargs):
    # gate=False (the guard tripped): theta and every state buffer, the
    # count included, stay bitwise the same; gate=True is the plain step.
    opt = resolve_optimizer(name, 0.01, kwargs)
    theta = torch.from_numpy(np.random.default_rng(2).normal(
        size=SIZE).astype(np.float32))
    state = opt.init(theta)
    grads = [torch.from_numpy(g) for g in _grads()[:3]]
    opt.update(theta, grads[0], state)
    before = theta.clone(), {k: v.clone() for k, v in state.items()}
    opt.update(theta, grads[1], state, gate=torch.tensor(False))
    assert torch.equal(theta, before[0])
    assert all(torch.equal(state[k], v) for k, v in before[1].items())
    twin = resolve_optimizer(name, 0.01, kwargs)
    theta2, state2 = before[0].clone(), {k: v.clone()
                                         for k, v in before[1].items()}
    opt.update(theta, grads[2], state, gate=torch.tensor(True))
    twin.update(theta2, grads[2], state2)
    assert torch.equal(theta, theta2)


def test_registry_defaults_are_pydens_tpus():
    # The defaults of pydens_tpu/utils/optimizers.py over optax 0.2.6, not
    # torch's.
    get = lambda name, **kw: resolve_optimizer(name, 0.01, kw)  # noqa: E731
    assert get("AdamW").weight_decay == 1e-4
    lion = get("Lion")
    assert (lion.b1, lion.b2, lion.weight_decay) == (0.9, 0.99, 1e-3)
    ada = get("Adagrad")
    assert (ada.eps, ada.initial_accumulator_value) == (1e-10, 0.1)
    rms = get("RMSprop")
    assert (rms.decay, rms.momentum, rms.centered) == (0.99, 0.0, False)
    assert "trace" in rms.init(torch.zeros(3))
    assert get("SGD").momentum is None and get("SGD", momentum=0).momentum \
        is None
    assert get("SGD", momentum=0.9).momentum == 0.9
    assert (get("Adadelta").rho, get("Adadelta").eps) == (0.9, 1e-6)
    with pytest.raises(TypeError, match="weight_decay"):
        get("Adam", weight_decay=0.1)
    with pytest.warns(UserWarning, match="unsupported optimizer kwargs"):
        get("Lion", eps=1.0)


def test_factory_and_objects_are_accepted():
    # As pydens_tpu: an object with init/update passes through, and a
    # factory f(learning_rate=..., **kwargs) is called.
    sgd = topt.SGD(0.1)
    assert resolve_optimizer(sgd, 0.5, {}) is sgd
    built = resolve_optimizer(topt.RMSprop, 0.02, {"decay": 0.5})
    assert isinstance(built, topt.RMSprop)
    assert (built.lr, built.decay) == (0.02, 0.5)
    with pytest.raises(ValueError, match="unknown optimizer"):
        resolve_optimizer("Adamm", 0.1, {})
    # The finishers, by name (lr is theirs to choose: a set one warns) and
    # as objects.
    for name, cls in (("LBFGS", topt.LBFGS), ("LM", topt.LMConfig),
                      ("gauss-newton", topt.LMConfig)):
        with pytest.warns(UserWarning, match="lr argument is ignored"):
            assert isinstance(resolve_optimizer(name, 0.1, {}), cls)
        built = resolve_optimizer(name, 0.005, {})
        assert resolve_optimizer(built, 0.1, {}) is built
    with pytest.raises(ValueError, match="cg_iters"):
        topt.LMConfig(cg_iters=0)


# -- w5 fits against pydens_tpu ----------------------------------------------

class _FixedBatch:
    """Host-protocol sampler (no device path) returning fixed points."""

    def __init__(self, pts):
        self.pts = pts

    def sample(self, size):
        return self.pts[:size]


def _inverse(pdt):
    def odevar(f, x):
        return (pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
                + pdt.V("new_var", data=np.array([1.0])))
    return odevar, dict(ndims=1, initial_condition=1,
                        constraints=lambda f, x: f(np.array([0.5])))


def _two_phase(solver, pts, **kw):
    solver.model.freeze_trainable(variables=("new_var",))
    solver.fit(niters=8, batch_size=len(pts), lr=0.1, progress=False,
               sampler=_FixedBatch(pts), resample=False, **kw)
    solver.model.unfreeze_trainable(variables=["new_var"])
    solver.fit(niters=8, batch_size=len(pts), lr=0.1, progress=False,
               sampler=_FixedBatch(pts), resample=False,
               loss_terms=["equation", "constraint_0"], **kw)
    return solver


@pytest.mark.parametrize("kw", [dict(optimizer="SGD", momentum=0.9),
                                dict(optimizer="AdamW")],
                         ids=["sgd_momentum", "adamw"])
def test_two_phase_w5_fit_tracks_jax(kw):
    # w5's two phases, 8 + 8 steps at lr 0.1 on one fixed batch, with the
    # tolerance of test_torch_tutorials.py's Adam fit (rtol 1e-3 on the
    # losses, 1e-3 on theta).  AdamW decays the frozen new_var too, as in
    # pydens_tpu (the mask zeroes the gradient, not the decay).
    pts = np.random.default_rng(11).uniform(size=(256, 1)).astype(np.float32)
    eq, skw = _inverse(jpdt)
    js = _two_phase(jpdt.Solver(eq, seed=0, **skw), pts, **kw)
    eq, skw = _inverse(jpdt)
    ref0 = jpdt.Solver(eq, seed=0, **skw).model.params
    eq, skw = _inverse(tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **skw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray, ref0)))
    _two_phase(ts, pts, **kw)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-3)
    jtheta = np.concatenate([np.ravel(np.asarray(p))
                             for p in jax.tree.leaves(js.model.params)])
    ttheta = ts._build_loss_fn((("equation", 1.0),), mse_loss).spec.flatten(
        ts.model.params).detach().numpy()
    assert float(np.abs(ttheta - jtheta).max()) <= 1e-3
    assert ts.history[-1]["optimizer"] == js.history[-1]["optimizer"]
