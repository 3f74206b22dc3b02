"""pydens_tpu_torch imports torch and never jax.

A plain ``import`` check proves nothing in a process where jax is already
loaded (this image's interpreter imports it at startup), so the package is
imported and trained in a subprocess where ``import jax`` and ``import
optax`` fail (the README fit, a w5-like fit with a sampler product, a
constraint and a freeze, then a fit with a schedule and SGD, a save and a
load, then L-BFGS and Levenberg-Marquardt fits, the collocation options,
Deep Ritz and ``Solver.residual``, the symbolic layer and the separable
model, an export round trip and a module model's fit on a world-of-one
gloo mesh), and every file of the package and of ``examples_torch/`` is
scanned for a jax import (the server that examples_torch/19 writes, for
any import beyond the standard library and torch), as is every file of
``tutorials_torch/`` and every code cell of its notebooks."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pydens_tpu_torch"

_BLOCK_JAX_AND_FIT = """
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "optax", "flax",
                              "pydens_tpu"):
        del sys.modules[name]
sys.modules["jax"] = None        # any `import jax` now raises ImportError
sys.modules["optax"] = None
sys.modules["pydens_tpu"] = None
import numpy as np
import torch
import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D

def pde(f, x, y):
    return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))

s = Solver(pde, ndims=2, boundary_condition=1, layout="fa fa fa f",
           activation="Tanh", units=[10, 12, 15, 1], device="cpu")
s.fit(batch_size=100, niters=10, progress=False)
assert len(s.losses) == 10 and np.isfinite(s.losses).all()
assert s.predict(np.zeros(3), np.linspace(0, 1, 3)).shape == (3, 1)

# A w5-like fit: a product NS sampler, a V variable frozen in the first
# phase, then a constraint term.
def ode(f, x, e):
    return D(f, x) - e * torch.cos(e * x) + pdt.V("k", data=[1.0])

s = Solver(ode, ndims=1, nparams=1, initial_condition=1.0, device="cpu",
           constraints=lambda f, x, e: f(np.array([0.5]), 1.0))
s.model.freeze_layers(variables=["k"])
s.fit(batch_size=50, niters=5, lr=0.1, progress=False,
      sampler=pdt.NS("u") & pdt.NS("u", low=.5, high=2))
assert s.model.params["variables"]["k"].item() == 1.0
s.model.unfreeze_layers(variables=["k"])
s.fit(batch_size=50, niters=5, lr=0.1, progress=False,
      loss_terms=["equation", "constraint_0"])
assert s.model.params["variables"]["k"].item() != 1.0
assert np.isfinite(s.losses).all() and len(s.history) == 2

# The loop features: a schedule, another optimizer, save and load.
import os, tempfile
from pydens_tpu_torch.utils.schedules import cosine_decay_schedule
s.fit(batch_size=50, niters=5, lr=cosine_decay_schedule(0.1, 5),
      optimizer="SGD", momentum=0.9, progress=False)
path = os.path.join(tempfile.mkdtemp(), "ckpt.npz")
s.save(path)
s2 = Solver(ode, ndims=1, nparams=1, initial_condition=1.0, device="cpu",
            seed=1, constraints=lambda f, x, e: f(np.array([0.5]), 1.0))
s2.load(path)
assert s2.losses == s.losses and len(s2.history) == 3
assert s2.model.params["variables"]["k"].item() == \\
    s.model.params["variables"]["k"].item()

# The finishers: L-BFGS (its zoom linesearch) and LM on a fixed batch.
s2.fit(batch_size=64, niters=3, optimizer="LBFGS", resample=False,
       progress=False)
s2.fit(batch_size=64, niters=2, optimizer="LM", resample=False,
       cg_iters=5, progress=False)
assert np.isfinite(s2.losses).all() and len(s2.history) == 5

# The collocation options, Deep Ritz and Solver.residual.
def heat(f, x, t):
    return D(f, t) - 0.1 * D(D(f, x), x)

s3 = Solver(heat, ndims=2, initial_condition=lambda x: torch.sin(np.pi * x),
            layout="fa f", features=[8, 1], device="cpu",
            constraints=lambda f, x, t: f.grad(np.zeros(1), np.zeros(1),
                                               wrt=0))
s3.fit(batch_size=32, niters=3, causal=5.0, progress=False)
s3.fit(batch_size=32, niters=3, adaptive=4, progress=False)
s3.fit(batch_size=32, niters=3, rba=True, resample=False, progress=False)
s3.fit(batch_size=32, niters=3, loss_terms=["equation", "constraint_0"],
       loss_balancing=("ntk", 1), progress=False)
assert len(s3.history[-1]["balanced_weights"]) == 2
assert s3.residual(np.zeros(4), np.ones(4)).shape == (4, 1)
s4 = Solver(lambda f, x: 0.5 * D(f, x) ** 2 - f, ndims=1,
            boundary_condition=0, formulation="variational", device="cpu")
s4.fit(batch_size=32, niters=3, progress=False)
assert np.isfinite(s3.losses).all() and np.isfinite(s4.losses).all()

# The symbolic layer and the separable model: a Field inverse problem, a
# laplace fit, predict_grad, a separable fit and predict_grid.
field = pdt.Field("s", features=[8, 1])
obs = torch.linspace(0, 1, 8).reshape(-1, 1)
s5 = Solver(lambda f, x: D(D(f, x), x) - field(x), ndims=1,
            boundary_condition=0, layout="fa f", features=[8, 1],
            device="cpu", constraints=lambda f, x: f(obs.numpy()) - obs)
s5.fit(batch_size=32, niters=3, loss_terms=["equation", "constraint_0"],
       progress=False)
assert field.predict(s5, np.linspace(0, 1, 4)).shape == (4, 1)
s6 = Solver(lambda f, x, y: pdt.laplace(f, x, y) - 1.0, ndims=2,
            boundary_condition=0, layout="fa f", features=[8, 1],
            device="cpu")
assert s6._plan_ok
s6.fit(batch_size=32, niters=3, progress=False)
assert s6.predict_grad(np.zeros(4), np.ones(4)).shape == (4, 2)
s7 = Solver(lambda f, x, y: pdt.laplace(f, x, y) - 1.0, ndims=2,
            boundary_condition=0, model=pdt.SeparableModel, layout="fa f",
            features=[8, 4], device="cpu")
s7.fit(batch_size=8, niters=3, progress=False)
assert s7.predict_grid(np.linspace(0, 1, 5), np.linspace(0, 1, 3)).shape \
    == (5, 3, 1)
assert pdt.uniform_grid([(0, 1), (0, 1)], 3).shape == (9, 2)
assert all(np.isfinite(s.losses).all() for s in (s5, s6, s7))

# Serving export, the module adapter and a world-of-one gloo mesh fit.
from pydens_tpu_torch import parallel, module_model
from pydens_tpu_torch.models import module_adapter
from pydens_tpu_torch.parallel.mesh import destroy_local_world
from pydens_tpu_torch.utils import export
fn = pdt.load_exported(s6.export(with_grad=True), device="cpu")
u, du = fn(np.zeros((4, 2), np.float32))
assert du.shape == (4, 2, 1)
np.testing.assert_allclose(u.numpy(), s6.predict(np.zeros((4, 2))),
                           rtol=1e-6, atol=1e-6)
net = torch.nn.Sequential(torch.nn.Linear(1, 8), torch.nn.Tanh(),
                          torch.nn.Linear(8, 1))
s8 = Solver(lambda f, x: D(f, x) - 1.0, ndims=1, device="cpu",
            model=module_model(net), mesh=pdt.make_mesh(device="cpu"))
s8.fit(batch_size=32, niters=3, progress=False)
assert parallel.distributed.is_multi_process(s8.mesh) is False
destroy_local_world()
assert np.isfinite(s8.losses).all() and isinstance(
    s8.model, module_adapter.ModuleModel)
loaded = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "optax")
                and sys.modules[n] is not None)
assert not loaded, loaded
print("ok")
"""


def test_package_imports_and_trains_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX_AND_FIT],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + sorted((REPO / "examples_torch").glob("*.py"))
                         + sorted((REPO / "tutorials_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "optax", "flax", "pydens_tpu"}, roots


@pytest.mark.parametrize("path", sorted(
    (REPO / "tutorials_torch").glob("*.ipynb")), ids=lambda p: p.name)
def test_no_notebook_cell_imports_jax(path):
    cells = json.loads(path.read_text())["cells"]
    roots = set()
    for cell in cells:
        if cell["cell_type"] != "code":
            continue
        for node in ast.walk(ast.parse("".join(cell["source"]))):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add((node.module or "").split(".")[0])
    assert "pydens_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "flax", "pydens_tpu"}, roots


def test_served_artifact_script_imports_torch_alone():
    # examples_torch/19 writes its server from the string _SERVER: the
    # deployment unit is the artifact, so the server imports the standard
    # library, torch and nothing of either package.
    path = REPO / "examples_torch" / "19_serving_http.py"
    source = next(
        ast.literal_eval(node.value)
        for node in ast.parse(path.read_text()).body
        if isinstance(node, ast.Assign)
        and [t.id for t in node.targets] == ["_SERVER"])
    tree = ast.parse(source)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "torch" in roots
    assert not roots - set(sys.stdlib_module_names) - {"torch"}, roots


def test_chip_smoke_imports_no_jax():
    roots = set(_imported_roots(REPO / "chip_smoke.py"))
    assert not roots & {"jax", "jaxlib", "optax", "flax", "pydens_tpu"}, roots
