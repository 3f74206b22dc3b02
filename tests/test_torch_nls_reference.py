"""Raissi et al.'s Schrodinger PINN in the port (the periodic embedding's
Taylor state on the fused Taylor kernels, the initial condition bound by
the gate, two outputs) held to its plain reference (``nls_reference.py``:
float32 PyTorch, nested autograd, optax's Adam) at a small size on the CPU:
loss, gradient and three Adam steps from seeded random weights, on the
kernels' route (their plain twin here) and on the plain traversal.  The
reference loads nothing of the program, of JAX or of ``pydens_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nls_reference as ref
from one_thread import one_thread  # noqa: F401
from pydens_tpu_torch import D, NumpySampler, Solver

CONFIG = {"equation": "nls", "ndims": 2,
          "domain": [[-5.0, 5.0], [0.0, float(np.pi / 2)]],
          "periodic": {"0": 1}, "layout": "fa fa f", "activation": "Tanh",
          "units": [16, 16, 2]}


def _nls(f, x, t):
    u, v = f[:, 0:1], f[:, 1:2]
    mag2 = u * u + v * v
    return (D(u, t) + 0.5 * D(D(v, x), x) + mag2 * v,
            -D(v, t) + 0.5 * D(D(u, x), x) + mag2 * u)


def _solver(config, route):
    s = Solver(_nls, ndims=2, domain=[tuple(d) for d in config["domain"]],
               periodic={int(d): m for d, m in config["periodic"].items()},
               periodic_ic_decay=False,
               initial_condition=lambda x: torch.stack(
                   [2.0 / torch.cosh(x), torch.zeros_like(x)], -1),
               layout=config["layout"], activation=config["activation"],
               units=config["units"], device="cpu", seed=3)
    if route == "plain":
        s.model._taylor_kernels = False
        s.model._taylor_plans.clear()
    return s


def _load(solver, config, theta):
    tree = {"net": {}, "variables": {}}
    for path, leaf in ref.unflatten(config, theta).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    solver.model.load_params(tree)


def _flat(solver, config):
    params = solver.model.params
    parts = []
    for path, _ in ref.leaf_layout(config):
        node = params
        for key in path:
            node = node[key]
        parts.append(node.detach().reshape(-1))
    return torch.cat(parts)


@pytest.mark.parametrize("harmonics", [1, 2])
@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_loss_gradient_and_adam_match_the_reference(route, harmonics,
                                                    one_thread):
    config = dict(CONFIG, periodic={"0": harmonics})
    s = _solver(config, route)
    bounds = ref.init_bounds(config, "cpu")
    gen = torch.Generator().manual_seed(11 + harmonics)
    theta = (2 * torch.rand(bounds.shape, generator=gen) - 1) * bounds
    # A gate scale away from 0, so that log_scale's gradient is not the
    # one of its start alone.
    theta[0] = 0.25
    _load(s, config, theta)
    assert torch.equal(_flat(s, config), theta)
    sampler = (NumpySampler("u", low=-5.0, high=5.0)
               & NumpySampler("u", low=0.0, high=float(np.pi / 2)))
    drawn = []
    draw = s._sample

    def watched(*args):
        pts = draw(*args)
        drawn.append(pts[0].clone())
        return pts
    s._sample = watched
    before = dict(s.model._taylor_traversals)
    s.fit(niters=1, batch_size=64, sampler=sampler, lr=1e-3,
          resample=False, progress=False)
    state = s._opt_state
    grad = state["mu"] / (1 - ref.ADAM_B1)
    s.fit(niters=2, batch_size=64, sampler=sampler, optimizer=None,
          resample=False, progress=False)
    routed = {k: v - before[k] for k, v in s.model._taylor_traversals.items()}
    assert routed == {"kernels": 3 * (route == "kernels"),
                      "plain": 3 * (route == "plain")}
    batches = [drawn[0], drawn[1], drawn[1]]
    assert batches[0].shape == (64, 2)
    losses, rgrad, theta3 = ref.adam_steps(config, theta, batches, 1e-3)
    np.testing.assert_allclose(s.losses, losses, rtol=2e-5)
    np.testing.assert_allclose(grad.numpy(), rgrad.numpy(), rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(_flat(s, config).numpy(), theta3.numpy(),
                               rtol=1e-4, atol=1e-6)
    assert abs(float(rgrad[0])) > 1e-4      # log_scale is trained
    u = s.predict(batches[0].numpy())
    np.testing.assert_allclose(
        u, ref.predict(config, theta3, batches[0]).numpy(), rtol=1e-5,
        atol=1e-5)


def test_the_solution_holds_the_initial_condition(one_thread):
    bounds = ref.init_bounds(CONFIG, "cpu")
    theta = (2 * torch.rand(bounds.shape,
                            generator=torch.Generator().manual_seed(1))
             - 1) * bounds
    x = torch.linspace(-5, 5, 11)[:, None]
    u = ref.solution(CONFIG, theta, torch.cat([x, torch.zeros_like(x)], 1))
    np.testing.assert_allclose(u[:, 0].numpy(),
                               (2 / torch.cosh(x[:, 0])).numpy(), rtol=1e-6)
    assert float(u[:, 1].abs().max()) == 0


def test_the_reference_loads_nothing_of_the_program():
    here = Path(__file__).resolve().parent
    script = f"""
import sys, json, torch
sys.path.insert(0, {str(here)!r})
import nls_reference as ref
cfg = json.loads({json.dumps(json.dumps(CONFIG))})
theta = torch.zeros(ref.init_bounds(cfg, 'cpu').numel())
ref.adam_steps(cfg, theta, [torch.rand(8, 2)], 1e-3)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}}
                        & {{'jax', 'jaxlib', 'flax', 'pydens_tpu',
                           'pydens_tpu_torch', 'portbench'}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=here)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
