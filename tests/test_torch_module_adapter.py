"""A torch ``nn.Module`` as the PINN network body (``module_model``), the
twin of tests/test_flax_adapter.py, and held to ``flax_model`` at a fixed
theta: the Flax ``Net`` and its torch twin, with the weights carried
across by ``module_params_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

flax = pytest.importorskip("flax")
import flax.linen as fnn  # noqa: E402

import pydens_tpu as jpdt  # noqa: E402
import pydens_tpu_torch as tpdt  # noqa: E402
from pydens_tpu.models.flax_adapter import flax_model  # noqa: E402
from pydens_tpu_torch import D, Solver, module_model  # noqa: E402
from pydens_tpu_torch.interop import module_params_from_flax  # noqa: E402
from pydens_tpu_torch.utils.criteria import mse_loss  # noqa: E402

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


class Net(nn.Module):
    """tests/test_flax_adapter.py's Net: two Tanh layers of 24, then 1."""

    def __init__(self, in_dim=1):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, 24)
        self.Dense_1 = nn.Linear(24, 24)
        self.Dense_2 = nn.Linear(24, 1)

    def forward(self, x):
        x = torch.tanh(self.Dense_0(x))
        x = torch.tanh(self.Dense_1(x))
        return self.Dense_2(x)


class FlaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.tanh(fnn.Dense(24)(x))
        x = fnn.tanh(fnn.Dense(24)(x))
        return fnn.Dense(1)(x)


def _ode(pdt):
    def ode(f, x):
        return pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
    return ode


def test_module_model_solves_ode():
    solver = Solver(_ode(tpdt), ndims=1, initial_condition=.5,
                    model=module_model(Net()), seed=0, device="cpu")
    assert not solver._plan_ok      # no Taylor plan: nested D
    solver.fit(niters=500, batch_size=400, lr=0.01, progress=False)
    xs = np.linspace(0, 1, 50)
    err = np.max(np.abs(solver.predict(xs).ravel()
                        - (np.sin(2 * np.pi * xs) + .5)))
    assert err < 0.08


def test_module_model_freeze_by_layer_name():
    def ode(f, x):
        return D(f, x) - 1.0

    solver = Solver(ode, ndims=1, model=module_model(Net()), seed=0,
                    device="cpu")
    assert set(solver.params["net"]) == {"Dense_0", "Dense_1", "Dense_2"}
    w = solver.params["net"]["Dense_0"]["weight"].detach().clone()
    w1 = solver.params["net"]["Dense_1"]["weight"].detach().clone()
    solver.model.freeze_trainable(layers=["Dense_0"])
    solver.fit(niters=30, batch_size=64, progress=False)
    torch.testing.assert_close(solver.params["net"]["Dense_0"]["weight"], w)
    assert not torch.equal(solver.params["net"]["Dense_1"]["weight"], w1)


def test_module_model_with_ensemble_and_checkpoint(tmp_path):
    def ode(f, x):
        return D(f, x) - 1.0

    solver = Solver(ode, ndims=1, model=module_model(Net()), seed=0,
                    n_models=2, device="cpu")
    assert solver.params["net"]["Dense_0"]["weight"].shape == (2, 24, 1)
    # Each member its own draw.
    w = solver.params["net"]["Dense_0"]["weight"]
    assert not torch.equal(w[0], w[1])
    solver.fit(niters=20, batch_size=64, progress=False)
    path = str(tmp_path / "module.npz")
    solver.save(path)
    s2 = Solver(ode, ndims=1, model=module_model(Net()), seed=9, n_models=2,
                device="cpu")
    s2.load(path)
    np.testing.assert_allclose(s2.predict([0.3]), solver.predict([0.3]),
                               rtol=1e-6)
    assert solver.predict_all([0.3]).shape == (2, 1, 1)


def test_module_stateful_module_rejected():
    bn_net = nn.Sequential(nn.Linear(1, 8), nn.BatchNorm1d(8),
                           nn.Linear(8, 1))

    def ode(f, x):
        return D(f, x)

    with pytest.raises(ValueError, match="non-parameter collections"):
        Solver(ode, ndims=1, model=module_model(bn_net), seed=0,
               device="cpu")


def test_module_model_init_is_a_function_of_the_seed():
    # theta0 depends on the Solver's seed only, not on the global RNG, and
    # the module handed in is left as it was.
    net = Net()
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def make(seed):
        torch.manual_seed(1234 + seed * 7)   # moves the global RNG
        return Solver(_ode(tpdt), ndims=1, initial_condition=.5,
                      model=module_model(net), seed=seed, device="cpu")

    a, b, c = make(0), make(0), make(1)
    torch.testing.assert_close(a._spec().flatten(a.params),
                               b._spec().flatten(b.params), rtol=0, atol=0)
    assert not torch.equal(a._spec().flatten(a.params),
                           c._spec().flatten(c.params))
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])


def _jax_pair():
    js = jpdt.Solver(_ode(jpdt), ndims=1, initial_condition=.5,
                     model=flax_model(FlaxNet()), seed=0)
    js.model.params["log_scale"] = jnp.asarray(0.3, jnp.float32)
    ts = Solver(_ode(tpdt), ndims=1, initial_condition=.5,
                model=module_model(Net()), seed=0, device="cpu")
    host = jax.tree.map(np.asarray, js.model.params)
    ts.model.load_params({
        "net": module_params_from_flax(host["net"], ts.model.module),
        "log_scale": torch.tensor(0.3), "variables": {}})
    return js, ts


def test_module_model_matches_flax_model_at_fixed_theta():
    # Equal loss and theta-gradient at fixed points (loss rtol 2e-5,
    # gradients rtol 2e-3 / atol 2e-5, tests/test_torch_solver.py's
    # tolerances); each Dense kernel's gradient is its Linear weight's,
    # transposed.
    js, ts = _jax_pair()
    assert js._plan_ok == ts._plan_ok is False
    pts = np.random.default_rng(7).uniform(size=(100, 1)).astype(np.float32)
    crit = lambda a, b: jnp.mean((a - b) ** 2)  # noqa: E731
    jloss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                     use_plan=False)
    jl, jg = jax.value_and_grad(jloss_fn)(js.model.params,
                                          [jnp.asarray(pts)])
    loss_fn = ts._build_loss_fn((("equation", 1.0),), mse_loss,
                                use_plan=False)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    tl = loss_fn(theta, torch.from_numpy(pts))
    tg, = torch.autograd.grad(tl, theta)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    tree = loss_fn.spec.unflatten(tg)
    for i in range(3):
        dense = jg["net"][f"Dense_{i}"]
        np.testing.assert_allclose(
            tree["net"][f"Dense_{i}"]["weight"].numpy(),
            np.asarray(dense["kernel"]).T, **GRAD_TOL)
        np.testing.assert_allclose(tree["net"][f"Dense_{i}"]["bias"].numpy(),
                                   np.asarray(dense["bias"]), **GRAD_TOL)
    np.testing.assert_allclose(float(tree["log_scale"]),
                               float(jg["log_scale"]), **GRAD_TOL)
    xs = np.linspace(0, 1, 17)
    np.testing.assert_allclose(ts.predict(xs), np.asarray(js.predict(xs)),
                               rtol=1e-5, atol=1e-6)
