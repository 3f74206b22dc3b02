"""Generates tutorials_torch/2_torch_examples.ipynb: the notebook
tutorials/2_torch_examples.ipynb (the migration of the reference's
``_torch_examples.ipynb``: torch-spelled equations, grid prediction, the
localized-source Laplace problem, the parametric ODE family, the heat
plate and the two two-phase ``freeze_layers`` inverse flows ending in
``solver.ctx.run(solver.model, xs)``) driving pydens_tpu_torch, cell for
cell, with the same budgets, seeds and inline asserts.  The first code
cell sets ``DEVICE = None``, the card, and every ``Solver`` takes
``device=DEVICE``; ``DEVICE = 'cpu'`` runs the notebook on the CPU.  Run
this script to (re)build the notebook; it needs the standard library
alone (``notebook_json``)."""

import os

from notebook_json import code, md, write


CELLS = [
    md("""# PyDEns examples, migrated

This notebook mirrors the reference's `examples/_torch_examples.ipynb`
side-by-side: same sections, same equations (torch math kept verbatim —
`torch.cos` on a coordinate symbol dispatches through `__torch_function__`
to the differentiable symbolic twin), same two-phase inverse-problem
flows.  Budgets are trimmed so the whole notebook executes in CI."""),
    code("""
import numpy as np
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D, V, NumpySampler as NS

DEVICE = None  # the card; 'cpu' runs on the CPU
"""),
    md("""## Custom models

The reference sketches a hand-written `TorchModel` subclass with a skip
connection.  Here the layout grammar expresses the same body declaratively
— `R` opens a residual branch, `+` closes it with a sum — and a custom
`torch.nn.Module` can be dropped in through the adapter when a
hand-written network is really wanted (`module_model`, `ModuleModel`)."""),
    code("""
# fc(20) tanh | skip open | fc(30) tanh | fc(20) | skip add | tanh | fc(1)
skip_solver = Solver(lambda f, x: D(f, x) - 2 * np.pi
                     * torch.cos(2 * np.pi * x),
                     ndims=1, initial_condition=.5,
                     layout='fa R fa f + a f',
                     features=[20, 30, 20, 1], activation='Tanh',
                     device=DEVICE)
skip_solver.fit(niters=300, batch_size=400, lr=0.02, progress=False)
print('skip-net final loss:', float(skip_solver.losses[-1]))
"""),
    md("""## Simple ODE

$f'(x) = 2\\pi\\cos(2\\pi x)$, $f(0)=\\tfrac12$ — the torch equation
verbatim (reference cells 7-11)."""),
    code("""
def ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)

solver = Solver(ode, ndims=1, initial_condition=torch.tensor(.5),
                device=DEVICE)
solver.fit(niters=1500, batch_size=400, progress=False)

xs = np.linspace(0, 1, 100)
approxs = solver.predict(xs).ravel()
true = np.sin(2 * np.pi * xs) + .5
print('max |err| =', np.abs(approxs - true).max())
assert np.abs(approxs - true).max() < 0.05
"""),
    md("""## Simple PDE

2D Poisson with $f=1$ on the boundary; predictions on a dense Cartesian
grid (reference cells 13-21 — the reference builds the grid with a
`cart_prod` helper and calls the model directly; `predict` accepts the
same per-column arrays)."""),
    code("""
def pde(f, x, y):
    return (D(D(f, x), x) + D(D(f, y), y)
            - 5 * torch.sin(np.pi * (x + y)))

solver = Solver(pde, ndims=2, boundary_condition=1, device=DEVICE)
solver.fit(niters=500, batch_size=400, lr=0.05, progress=False)

def cart_prod(*arrs):
    grids = np.meshgrid(*arrs, indexing='ij')
    return np.stack([g.ravel() for g in grids], axis=1)

grid = cart_prod(np.linspace(0, 1, 100), np.linspace(0, 1, 100))
approxs = solver.predict(grid[:, 0:1], grid[:, 1:2]).reshape((100, 100))
# the ansatz binds the boundary exactly
assert np.allclose(approxs[0], 1.0, atol=1e-5)
assert np.allclose(approxs[:, -1], 1.0, atol=1e-5)
print('interior range:', approxs.min(), approxs.max())
"""),
    md("""## PDE: Laplace with a fading bulb

A localized source term written with `torch.exp` (reference cells
25-31)."""),
    code("""
def source(x, y):
    return (100 * x * (1 - x) * 4 * y * (.5 - y) * (1 - y) *
            torch.exp(-70 * (x - y)**2))

def bulb(f, x, y):
    return D(D(f, x), x) + D(D(f, y), y) - source(x, y)

solver = Solver(bulb, ndims=2, boundary_condition=1, device=DEVICE)
solver.fit(niters=900, batch_size=400, lr=0.05, progress=False)
print('fading-bulb final loss:', float(solver.losses[-1]))
approxs = solver.predict(grid[:, 0:1], grid[:, 1:2]).reshape((100, 100))
assert np.allclose(approxs[0], 1.0, atol=1e-5)
"""),
    md("""## Parametric family of ODEs

One network solves $f'(x) = \\epsilon\\pi\\cos(\\epsilon\\pi x)$ for every
$\\epsilon \\in [0.5, 5.5]$ at once — the parameter is an extra sampled
input column (reference cells 37-42)."""),
    code("""
def odeparam(f, x, e):
    return D(f, x) - e * np.pi * torch.cos(e * np.pi * x)

solver = Solver(odeparam, ndims=1, initial_condition=2, nparams=1,
                device=DEVICE)
sampler = NS('u') & NS('u', low=.5, high=5.5)
solver.fit(niters=4000, batch_size=700, sampler=sampler, progress=False)

# checking out the solution approximation for fixed epsilon
xs = np.linspace(0, 1, 100)
for eps in (1.0, 3.0, 5.0):
    approxs = solver.predict(xs, eps).ravel()
    true = np.sin(eps * np.pi * xs) + 2
    print(f'eps={eps}: max |err| = {np.abs(approxs - true).max():.4f}')
    assert np.abs(approxs - true).max() < 0.25
"""),
    md("""## Heat equation in 2D (metal plate)

$\\Delta f = a\\,\\partial_t f$ with a parametric diffusivity $a$, zero
boundary and a bump initial condition (reference cells 45-51)."""),
    code("""
def heat(f, x, y, t, a):
    return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)

solver = Solver(heat, ndims=3, nparams=1,
                initial_condition=lambda x, y: 10 * x * y * (1 - x) * (1 - y),
                boundary_condition=0, device=DEVICE)
sampler = NS('u', dim=2) & NS('u', low=0, high=.5) & NS('u', low=.1, high=4)
solver.fit(niters=1500, batch_size=1500, lr=0.01, sampler=sampler,
           progress=False)

def get_approxs(t=.1, param=1.):
    return solver.predict(grid[:, 0:1], grid[:, 1:2], t,
                          param).reshape((100, 100))

plate = get_approxs(t=.1, param=1.)
print('plate at t=.1 peak:', plate.max())
assert plate.max() > 0.05            # heat not yet dissipated
assert np.allclose(plate[0], 0.0, atol=1e-5)   # boundary exact
assert get_approxs(t=.5, param=1.).max() < plate.max()  # cooling in time
"""),
    md("""## ODE with trainable coefficients

The inverse flow (reference cells 66-78): an unknown constant enters the
equation through the `V` token, a point constraint pins the solution, and
training runs in two phases — first the *frozen-variable* phase learns the
solution for the initial guess, then the variable unfreezes and the
constraint joins the loss (the reference spells the kwarg `losses=`; both
spellings work)."""),
    code("""
def odevar(f, x):
    return (D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
            + V('new_var', data=torch.Tensor([1.0]), requires_grad=True))

solver = Solver(odevar, ndims=1, initial_condition=1,
                constraints=lambda f, x: f(torch.tensor([0.5])), device=DEVICE)

# * learning to solve the equation with fixed value of the variable
solver.model.freeze_layers(variables=('new_var',))
solver.fit(niters=2000, batch_size=400, progress=False)
xs = np.linspace(0, 1, 100)
phase1 = solver.predict(xs).ravel()
print('u(0.5) after phase 1:', solver.predict(np.array([0.5])).ravel()[0])
"""),
    md("""The additional constraint $f(0.5) = 0$ isn't satisfied — let's
fix it: unfreeze the variable and add the constraint term."""),
    code("""
solver.model.unfreeze_layers(variables=['new_var'])
solver.fit(niters=1500, batch_size=400,
           losses=['equation', 'constraint_0'], progress=False)

u_half = solver.predict(np.array([0.5])).ravel()[0]
new_var = float(np.asarray(solver.params['variables']['new_var'])[0])
print('u(0.5) =', u_half, '  learned new_var =', new_var)
assert abs(u_half) < 0.15
# the consistent coefficient: zero residual + f(0)=1 force
# f(x) = sin(2pi x) + 1 - new_var*x, and f(0.5)=0 then fixes new_var = 2
assert abs(new_var - 2.0) < 0.3
"""),
    md("""## ODE with trainable coefficients (2)

The main-page flow (reference cells 80-91): the *initial condition itself*
is the trainable `V('init')`, constrained by $u(0.5) = 2$.  Phase 1 learns
the solution at the frozen guess; phase 2 freezes the network body instead
and moves only the variables, ending with the reference's
`solver.ctx.run(solver.model, xs)` prediction idiom."""),
    code("""
def odevar(u, t):
    return D(u, t) - 2 * np.pi * torch.cos(2 * np.pi * t)

def initial(*args):
    return V('init', data=torch.Tensor([4.0]))

solver = Solver(odevar, ndims=1, initial_condition=initial,
                constraints=lambda u, t: u(torch.tensor([0.5])) - 2,
                device=DEVICE)

solver.model.freeze_layers(variables=('init',))
solver.fit(niters=150, batch_size=500, lr=0.05, progress=False)
xs = np.linspace(0, 1, 100)
phase1 = solver.predict(xs).ravel()
print('phase 1: u(0) =', phase1[0], ' u(0.5) =',
      solver.predict(np.array([0.5])).ravel()[0])
assert abs(phase1[0] - 4.0) < 1e-3   # IC bound exactly at the frozen guess
"""),
    code("""
solver.model.freeze_layers(['fc1', 'fc2', 'fc3'], ['log_scale'])
solver.model.unfreeze_layers(variables=['init'])
solver.fit(niters=100, batch_size=100, lr=0.1,
           losses=['equation', 'constraint_0'], progress=False)

approxs = np.asarray(solver.ctx.run(solver.model, xs)).ravel()
init = float(np.asarray(solver.params['variables']['init'])[0])
print('u(0.5) =', solver.predict(np.array([0.5])).ravel()[0],
      ' learned init =', init)
# u(t)=sin(2pi t)+init, so u(0.5)=2 drives init toward 2
assert abs(init - 2.0) < 0.5
assert np.abs(approxs - (np.sin(2 * np.pi * xs) + init)).max() < 0.1
"""),
    md("""Everything the reference's narrative exercises — torch-spelled
equations, the `losses=` alias, `freeze_layers(variables=...)` two-phase
flows, and `ctx.run` — runs unchanged on the rebuild."""),
]


def main():
    write(CELLS, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "2_torch_examples.ipynb"))


if __name__ == "__main__":
    main()
