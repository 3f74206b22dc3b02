"""The port's examples (``examples_torch/``): every file imports with no JAX
module loaded and exposes ``main``; 01, 05 and 06 run end to end on the
CPU with their own asserts; and the equations new to the port (examples
10, 11, 13, 20, 25 and 29) are held to pydens_tpu at a fixed theta: each
example's equation, constraints and ansatz options at width 8 in its own
layout, the JAX parameters copied in, the loss and the theta-gradient on
fixed points (causal eps included for 20 and 25) at the solver tests'
tolerances, and the Taylor plan (``_plan_ok``, ``_plan_derivs``) equal to
JAX's.  The examples' budgets and bounds are held on the card
(``chip_smoke.py --examples``)."""

import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu.numpy as jnp_sym
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss

from one_thread import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples_torch").glob("*.py"))
NAMES = ["01_simple_ode", "02_poisson_2d", "03_parametric_family",
         "04_heat_parametric", "05_inverse_problem", "06_custom_model",
         "10_data_assimilation", "11_kdv_soliton", "13_plate_bending",
         "18_distributed_data_parallel", "19_serving_http",
         "20_causal_convection", "25_allen_cahn", "29_eigenvalue_problem"]
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)

# Imports every example in a process where jax and pydens_tpu cannot be
# imported; prints, per file, whether main is callable and the JAX-side
# modules loaded.
_IMPORT_ALL = r"""
import importlib.util, json, sys
for name in ("jax", "jaxlib", "optax", "flax", "pydens_tpu"):
    sys.modules[name] = None
out = {}
for path in sys.argv[1:]:
    stem = path.rsplit("/", 1)[-1][:-3]
    spec = importlib.util.spec_from_file_location(stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out[stem] = callable(getattr(mod, "main", None))
out["_loaded"] = sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "optax",
                                               "flax", "pydens_tpu")
                        and sys.modules[n] is not None)
print(json.dumps(out))
"""


def test_the_fourteen_examples_are_there():
    assert [p.stem for p in EXAMPLES] == NAMES


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL] + [str(p) for p in EXAMPLES],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_without_jax_and_exposes_main(imported, name):
    # tests/test_examples.py's importable check, with jax unimportable.
    assert imported[name] is True
    assert imported["_loaded"] == []


def _load(name):
    path = REPO / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["01_simple_ode", "05_inverse_problem",
                                  "06_custom_model"])
def test_example_runs_on_the_cpu_with_its_own_asserts(name):
    # examples/ FAST set but 08 (phase 12 holds it on the card): main on
    # the CPU, its own asserts, its numbers returned.
    solver, numbers = _load(name).main(device="cpu")
    assert solver.device.type == "cpu"
    assert numbers and all(np.isfinite(v) for v in numbers.values())


def test_examples_run_on_the_card_unless_asked():
    # No fallback to the CPU: without a card, main() raises.
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("01_simple_ode").main()


# -- parity at a fixed theta ------------------------------------------------
# Each case: (equation and Solver keywords of a package, loss terms,
# causal (time column, lo, hi) and eps, or None).  ``pkg`` is pydens_tpu or
# pydens_tpu_torch, ``m`` its math on symbols and arrays (pydens_tpu.numpy,
# the lifted jax.numpy, or torch).

def _ex10(pkg, m):
    rng = np.random.default_rng(0)
    obs_x = rng.uniform(0.1, 0.9, size=(64, 1)).astype(np.float32)
    obs_t = rng.uniform(0.0, 0.2, size=(64, 1)).astype(np.float32)
    obs_u = (np.sin(np.pi * obs_x) * np.exp(-0.5 * np.pi ** 2 * obs_t)
             + 0.01 * rng.normal(size=obs_x.shape)).astype(np.float32)
    if m is torch:
        obs_u = torch.from_numpy(obs_u)

    def heat(f, x, t):
        return (pkg.D(f, t) - pkg.V("a", data=np.array([1.0]))
                * pkg.D(pkg.D(f, x), x))

    return heat, dict(
        ndims=2, initial_condition=lambda x: m.sin(np.pi * x),
        boundary_condition=0.0, domain=[(0, 1), (0, 0.2)], layout="fa fa f",
        features=[8, 8, 1], activation="Tanh",
        constraints=lambda f, x, t: f(obs_x, obs_t) - obs_u)


def _ex11(pkg, m):
    def kdv(f, x, t):
        return (pkg.D(f, t) + 6 * f * pkg.D(f, x)
                + pkg.D(pkg.D(pkg.D(f, x), x), x))
    return kdv, dict(ndims=2, domain=[(-5, 5), (0, 0.5)],
                     initial_condition=lambda x: 2.0 / m.cosh(x + 2.0) ** 2,
                     layout="fafaf", features=[8, 8, 1], activation="Tanh")


def _ex13(pkg, m):
    w = np.pi

    def plate(f, x, y):
        uxx = pkg.D(pkg.D(f, x), x)
        uyy = pkg.D(pkg.D(f, y), y)
        bih = (pkg.D(pkg.D(uxx, x), x) + 2 * pkg.D(pkg.D(uxx, y), y)
               + pkg.D(pkg.D(uyy, y), y))
        return bih / (4 * w ** 4) - m.sin(w * x) * m.sin(w * y)

    e = np.linspace(0, 1, 17).astype(np.float32)
    z, o = np.zeros_like(e), np.ones_like(e)
    cons = (lambda f, x, y: f.grad(z, e, wrt=(0, 0)),
            lambda f, x, y: f.grad(o, e, wrt=(0, 0)),
            lambda f, x, y: f.grad(e, z, wrt=(1, 1)),
            lambda f, x, y: f.grad(e, o, wrt=(1, 1)))
    return plate, dict(ndims=2, boundary_condition=0, layout="fa fa f",
                       features=[8, 8, 1], activation="Tanh",
                       constraints=cons)


def _ex20(pkg, m):
    def convection(f, x, t):
        return pkg.D(f, t) + 4.0 * pkg.D(f, x)
    return convection, dict(
        ndims=2, periodic=(0,), initial_condition=lambda x: m.sin(
            2 * np.pi * x), activation="Tanh", features=[8, 8, 8, 1],
        layout="fa fa fa f")


def _ex25(pkg, m):
    def allen_cahn(f, x, t):
        return (pkg.D(f, t) - 1e-4 * pkg.D(pkg.D(f, x), x)
                - 5.0 * (f - f ** 3))
    return allen_cahn, dict(
        ndims=2, domain=[(-1, 1), (0, 1)],
        initial_condition=lambda x: x ** 2 * m.cos(np.pi * x),
        periodic={0: 10}, periodic_ic_decay=False, activation="Tanh",
        layout="fa fa fa fa f", features=[8, 8, 8, 8, 1])


def _ex29(pkg, m):
    xq = np.linspace(0.0, 1.0, 257, dtype=np.float32)[:, None]

    def helmholtz(f, x):
        return (pkg.D(pkg.D(f, x), x)
                + pkg.V("lam", data=np.array([8.0])) * f)

    def positivity(fwd, x):
        u = fwd(xq)
        return (torch.minimum(u, torch.zeros_like(u)) if m is torch
                else m.minimum(u, 0.0))

    return helmholtz, dict(
        ndims=1, boundary_condition=0, layout="fa fa f", features=[8, 8, 1],
        activation="Tanh",
        constraints=[lambda fwd, x: m.mean(fwd(xq) ** 2) - 1.0, positivity,
                     lambda fwd, x: fwd(0.5) - np.sqrt(2.0,
                                                       dtype=np.float32)])


def _terms(n, weight):
    return (("equation", 1.0),) + tuple(
        (f"constraint_{k}", weight) for k in range(n))


# name: (builder, loss terms, causal, eps)
PARITY = {
    "10_data_assimilation": (_ex10, _terms(1, 50.0), None, None),
    "11_kdv_soliton": (_ex11, _terms(0, 0.0), None, None),
    "13_plate_bending": (_ex13, _terms(4, 5.0), None, None),
    "20_causal_convection": (_ex20, _terms(0, 0.0), (1, 0.0, 1.0), 5.0),
    "25_allen_cahn": (_ex25, _terms(0, 0.0), (1, 0.0, 1.0), 20.0),
    "29_eigenvalue_problem": (_ex29, _terms(3, 20.0), None, None),
}


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    eq, kw = PARITY[name][0](jpdt, jnp_sym)
    return jpdt.Solver(eq, seed=0, **kw)


def _points(ts, n=64, seed=7):
    """``n`` points inside the domain, from a numpy seed."""
    dom = np.asarray(ts.model.domain, np.float32)
    u = np.random.default_rng(seed).uniform(size=(n, len(dom)))
    return (dom[:, 0] + (dom[:, 1] - dom[:, 0]) * u).astype(np.float32)


@pytest.mark.parametrize("name", list(PARITY))
def test_example_equation_matches_pydens_tpu_at_a_fixed_theta(name):
    build, terms, causal, eps = PARITY[name]
    js = _jax_solver(name)
    eq, kw = build(tpdt, torch)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    # The same plan: 11's order-3 taps, 13's mixed order-4 (0, 0, 1, 1).
    assert ts._plan_ok == js._plan_ok
    assert set(map(tuple, ts._plan_derivs)) == set(map(tuple,
                                                       js._plan_derivs))
    pts = _points(ts)
    jloss_fn, *_ = js._build_loss_fn(
        terms, lambda a, b: jnp.mean((a - b) ** 2), use_plan=True,
        causal=causal)
    leaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]
    jeps = None if eps is None else jnp.float32(eps)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, leaves, None, None, jeps)))(js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True,
                                causal=causal)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts), causal_eps=None
                   if eps is None else torch.tensor(eps))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    flat = np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(jg)])
    np.testing.assert_allclose(grad.numpy(), flat, **GRAD_TOL)


def test_plate_constraints_compose_in_forward_mode(monkeypatch):
    # examples/13's f.grad moment constraints take forward mode written out
    # (the plain traversal and the ansatz on jets): no torch.autograd.grad
    # or backward runs while the loss is built, as pydens_tpu's nested
    # jvp.  A create_graph backward would add nodes that the device thread
    # numbers after the process's earlier autograd work, so the fit would
    # depend on that work.  The gradient still equals pydens_tpu's (the
    # parity case above).
    eq, kw = _ex13(tpdt, torch)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    terms = PARITY["13_plate_bending"][1]
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    calls = []
    for name in ("grad", "backward"):
        real = getattr(torch.autograd, name)
        monkeypatch.setattr(torch.autograd, name, lambda *a, real=real,
                            name=name, **k: calls.append(name)
                            or real(*a, **k))
    loss = loss_fn(theta, torch.from_numpy(_points(ts)))
    assert calls == []
    monkeypatch.undo()
    assert torch.isfinite(loss) and loss.requires_grad
