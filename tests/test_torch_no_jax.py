"""pydens_tpu_torch imports torch and never jax.

A plain ``import`` check proves nothing in a process where jax is already
loaded (this image's interpreter imports it at startup), so the package is
imported and trained in a subprocess where ``import jax`` and ``import
optax`` fail (the README fit, a w5-like fit with a sampler product, a
constraint and a freeze, then a fit with a schedule and SGD, a save and a
load, then L-BFGS and Levenberg-Marquardt fits),
and every file of the package is scanned for a jax import."""

import ast
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


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "optax", "flax", "pydens_tpu"}, roots


def test_chip_smoke_imports_no_jax():
    roots = set(_imported_roots(REPO / "chip_smoke.py"))
    assert not roots & {"jax", "jaxlib", "optax", "flax", "pydens_tpu"}, roots
