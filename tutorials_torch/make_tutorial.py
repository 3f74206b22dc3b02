"""Generates tutorials_torch/1_solving_pdes.ipynb: the notebook
tutorials/1_solving_pdes.ipynb driving pydens_tpu_torch, cell for cell
(the same sections, equations, configurations, budgets, seeds and inline
asserts).  The first code cell sets ``DEVICE = None``, the card, and
every ``Solver`` and ``load_exported`` takes ``device=DEVICE``;
``DEVICE = 'cpu'`` runs the notebook on the CPU.  Run this script to
(re)build the notebook; it needs the standard library alone
(``notebook_json``)."""

import os

from notebook_json import code, md, write


CELLS = [
    md("""# Solving ODEs & PDEs with pydens_tpu_torch

This tutorial walks through every problem class the framework supports:

1. a simple ODE with an initial condition,
2. a 2D Poisson equation with an exact boundary condition,
3. a *parametric family* of ODEs solved by one network,
4. the heat equation on a plate with parametric diffusivity,
5. an *inverse problem* with a trainable coefficient (`V` token),
6. systems of coupled equations, ensembles, and adaptive collocation.

On the card every fit step after a configuration's first replays a captured
CUDA graph; with `DEVICE = 'cpu'` the same code runs unchanged on the CPU
(just slower)."""),
    code("""
import numpy as np
import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D, V, NumpySampler as NS

DEVICE = None  # the card; 'cpu' runs on the CPU
"""),
    md("""## 1. A simple ODE

Solve  $f'(x) = 2\\pi \\cos(2\\pi x)$, $f(0) = 0.5$  on $[0, 1]$.
Write the equation as a plain callable using the differentiation token `D`
and the symbolic math exported from `pydens_tpu_torch` (`pdt.cos` behaves
exactly like `torch.cos` on tensors, but stays differentiable on coordinate
symbols):"""),
    code("""
def ode(f, x):
    return D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)

solver = Solver(ode, ndims=1, initial_condition=.5,
                activation='Tanh', layout='fafaf', features=[12, 10, 1],
                device=DEVICE)
solver.fit(niters=500, batch_size=400, lr=0.02)

xs = np.linspace(0, 1, 100)
approx = solver.predict(xs).ravel()
print('max |error| vs sin(2*pi*x)+0.5:',
      np.abs(approx - (np.sin(2 * np.pi * xs) + .5)).max())
"""),
    md("""The initial condition holds *exactly* — the network output passes
through an ansatz transform that pins it at $t_0$ by construction.  The loss
history is in `solver.losses`; per-fit records in `solver.history`."""),
    md("""## 2. 2D Poisson with an exact boundary condition

$\\Delta f = 5\\sin(\\pi(x+y))$ on $[0,1]^2$ with $f = 1$ on the boundary."""),
    code("""
def pde(f, x, y):
    return D(D(f, x), x) + D(D(f, y), y) - 5 * pdt.sin(np.pi * (x + y))

solver = Solver(pde, ndims=2, boundary_condition=1,
                layout='fa fa fa f', activation='Tanh', units=[10, 12, 15, 1],
                device=DEVICE)
solver.fit(batch_size=100, niters=1500)

grid = pdt.uniform_grid([(0, 1), (0, 1)], 100)       # (10000, 2)
solution = solver.predict(grid).reshape(100, 100)
print('final residual loss:', solver.losses[-1])
print('boundary value check:', solver.predict(np.zeros(5),
                                              np.linspace(0, 1, 5)).ravel())
"""),
    md("""## 3. A parametric family of ODEs

$f'(x) = \\epsilon\\pi\\cos(\\epsilon\\pi x)$, $f(0) = 2$, for every
$\\epsilon \\in [0.5, 5.5]$ at once: the parameter is just an extra sampled
input column (`nparams=1`), drawn by a product sampler (`&`)."""),
    code("""
def odeparam(f, x, e):
    return D(f, x) - e * np.pi * pdt.cos(e * np.pi * x)

sampler = NS('u') & NS('u', low=.5, high=5.5)
solver = Solver(odeparam, ndims=1, nparams=1, initial_condition=2.0,
                device=DEVICE)
solver.fit(niters=2500, batch_size=700, sampler=sampler, lr=0.01)

for eps in (1.0, 2.5, 4.0):
    pred = solver.predict(xs, eps).ravel()
    true = np.sin(eps * np.pi * xs) + 2
    print(f'eps={eps}: max err {np.abs(pred - true).max():.3f}')
"""),
    md("""## 4. Heat equation with parametric diffusivity

$\\Delta f = a\\,\\partial_t f$ on the unit plate, $f|_{edge}=0$,
$f(x,y,0) = 10xy(1-x)(1-y)$, with $a$ sampled in $[0.1, 4]$."""),
    code("""
def heat(f, x, y, t, a):
    return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)

solver = Solver(heat, ndims=3, nparams=1,
                initial_condition=lambda x, y: 10 * x * y * (1 - x) * (1 - y),
                boundary_condition=0, layout='fafaf',
                features=[30, 40, 1], activation='Sigmoid', device=DEVICE)
hsampler = NS('u', dim=2) & NS('u', low=0, high=.5) & NS('u', low=.1, high=4)
solver.fit(niters=500, batch_size=1500, sampler=hsampler, lr=0.001)

grid = pdt.uniform_grid([(0, 1), (0, 1)], 40)
means = [solver.predict(grid[:, 0:1], grid[:, 1:2], t, 1.0).mean()
         for t in (0.0, 0.2, 0.45)]
print('mean plate temperature at t=0, 0.2, 0.45:', np.round(means, 4))
"""),
    md("""## 5. Inverse problem: a trainable coefficient

$f'(x) = 2\\pi\\cos(2\\pi x) - c$ with unknown $c$ (the `V` token), $f(0)=1$,
made well-posed by the interior constraint $f(0.5) = 0$.  Two-phase
training: first solve the equation with $c$ frozen, then unfreeze and let
the constraint drive $c \\to 2$."""),
    code("""
def odevar(f, x):
    return (D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
            + V('new_var', data=np.array([1.0])))

solver = Solver(odevar, ndims=1, initial_condition=1,
                constraints=lambda f, x: f(np.array([0.5])), device=DEVICE)

solver.model.freeze_trainable(variables=('new_var',))
solver.fit(niters=400, batch_size=500, lr=0.1)

solver.model.unfreeze_trainable(variables=['new_var'])
solver.fit(niters=300, batch_size=100, lr=0.1,
           loss_terms=['equation', 'constraint_0'])
print('recovered c =', float(np.asarray(
    solver.params['variables']['new_var'])[0]), '(true: 2)')
"""),
    md("""## 6. Beyond the reference: systems, ensembles, adaptive sampling

A coupled system with an exactly-bound vector initial condition, trained as
an 4-model ensemble, polished with full-batch L-BFGS:"""),
    code("""
omega = 2 * np.pi

def oscillator(f, x):          # u' = v,  v' = -omega^2 u
    u, v = f[:, 0:1], f[:, 1:2]
    return (D(u, x) - v, D(v, x) + omega ** 2 * u)

solver = Solver(oscillator, ndims=1, activation='Tanh',
                layout='fa fa f', features=[32, 32, 2],
                initial_condition=np.array([0.0, omega]), n_models=4,
                device=DEVICE)
solver.fit(niters=1000, batch_size=512, lr=0.01)

pred = solver.predict(xs)              # ensemble mean, (100, 2)
std = solver.predict_std(xs)           # epistemic uncertainty
print('u max err:', np.abs(pred[:, 0] - np.sin(omega * xs)).max())
print('mean uncertainty:', std.mean())
"""),
    code("""
# Adaptive collocation for stiff sources: importance-sample points where
# the residual is large (unbiased weighting), inside the compiled loop.
def stiff(f, x):
    return D(f, x) - 100 * pdt.exp(-2000 * (x - 0.8) ** 2)

adaptive = Solver(stiff, ndims=1, initial_condition=0.0, activation='Tanh',
                  layout='fafaf', features=[32, 32, 1], device=DEVICE)
adaptive.fit(niters=800, batch_size=128, lr=0.01, adaptive=8)
probe = np.linspace(0, 1, 2000)
print('mean |residual| with adaptive sampling:',
      adaptive.residual(probe).mean())
"""),
    md("""## 7. Higher-order PDEs (KdV, beams)

`D` nests to any order; orders ≤ 6 ride the Taylor-plan fast path (all
derivative taps in ONE network traversal).  A fourth-order Euler–Bernoulli
beam `u'''' = q` needs four boundary conditions: the ansatz binds the
Dirichlet pair, constraints on the forward closure bind the clamping pair
(`fwd.grad(points, wrt=0)`; `wrt=(0, 0)` would give bending moments):"""),
    code("""
def beam(f, x):
    return (D(D(D(D(f, x), x), x), x) - 384.0) / 384.0

left, right = np.array([0.], np.float32), np.array([1.], np.float32)
beam_solver = Solver(beam, ndims=1, boundary_condition=0, activation='Tanh',
                     layout='fa fa f', features=[24, 24, 1],
                     constraints=(lambda f, x: f.grad(left, wrt=0),
                                  lambda f, x: f.grad(right, wrt=0)),
                     device=DEVICE)
beam_solver.fit(niters=400, batch_size=256, lr=0.01,
                loss_terms={'equation': 1.0, 'constraint_0': 10.0,
                            'constraint_1': 10.0})
print('fourth-order taps planned:', beam_solver._plan_ok)
print('loss so far:', beam_solver.losses[-1])
# (examples/12_biharmonic_beam.py trains this to 1e-4 max error vs the
#  analytic 16 x^2 (1-x)^2 with an L-BFGS finishing phase.)
"""),
    md("""## 8. Automatic loss balancing

Multi-term losses often have mis-matched scales — a raw-magnitude
equation residual can be orders of magnitude larger than its constraint
terms and simply drown them.  `fit(loss_balancing=...)` measures gradient
norms during a warmup window and rescales the term weights automatically
(Wang et al.'s grad-norm rule, clipped and warmup-limited — see
BENCHMARKS.md for why balancing *forever* is destructive):"""),
    code("""
def beam_raw(f, x):            # deliberately mis-scaled: residual ~ 384
    return D(D(D(D(f, x), x), x), x) - 384.0

raw = Solver(beam_raw, ndims=1, boundary_condition=0, activation='Tanh',
             layout='fa fa f', features=[24, 24, 1],
             constraints=(lambda f, x: f.grad(left, wrt=0),
                          lambda f, x: f.grad(right, wrt=0)), device=DEVICE)
raw.fit(niters=600, batch_size=256, lr=0.01,
        loss_terms=['equation', 'constraint_0', 'constraint_1'],
        loss_balancing=50)
print('learned term weights:', np.round(raw.history[-1]['balanced_weights'], 1))
"""),
    md("""`loss_balancing='ntk'` swaps the statistic for per-term NTK
traces (per-row residual-Jacobian norms, Hutchinson-estimated) — prefer
it when per-point gradients oscillate and the batch-summed grad-norm
statistic cancels, e.g. high-frequency Helmholtz
(examples/31_ntk_balanced_helmholtz.py; measured A/B in BENCHMARKS.md
"NTK-trace loss balancing")."""),
    md("""## 9. Serving: export the trained field

A trained solution exports to a self-contained artifact
(`torch.export`): parameters baked in, batch dimension dynamic, loaded
onto the card or the CPU — the serving process needs only torch, not
pydens_tpu_torch or the Python equation:"""),
    code("""
blob = solver.export()                 # or solver.export('u.pdtx')
fn = pdt.load_exported(blob, device=DEVICE)
print('serve vs predict max diff:',
      np.abs(np.asarray(fn(xs.reshape(-1, 1).astype(np.float32)).cpu())
             - solver.predict(xs)).max())
"""),
    md("""## 10. High-frequency solutions: the spectral-bias toolkit

A plain MLP on raw coordinates cannot learn rapidly-oscillating
solutions at any budget (spectral bias).  Three composable fixes, all
compatible with the fast derivative plan:

- `fourier_features=(m, sigma)` appends sin/cos of a fixed random
  Gaussian projection of the inputs (pick `sigma` near the dominant
  frequency);
- `arch='modified'` swaps the chain for the gated modified-MLP body;
- `fit(causal=eps)` solves time-dependent transport front-to-back
  (anneal `eps` upward across fit calls — no recompile).

Measured on periodic convection `u_t + 30 u_x = 0` (BENCHMARKS.md):
raw chain fails outright (rel-L2 0.96); all three together reach
0.0065 at the same budget:"""),
    code("""
k = 6.0                      # try the toolkit on a high-frequency ODE
def hf_ode(f, x):
    return D(f, x) - 2 * np.pi * k * pdt.cos(2 * np.pi * k * x)

hf = Solver(hf_ode, ndims=1, fourier_features=(16, k), arch='modified',
            features=[32, 32, 1], activation='Tanh',
            constraints=lambda f, x: f(np.array([0.0])), device=DEVICE)
hf.fit(niters=1500, batch_size=512, lr=2e-3,
       loss_terms={'equation': 1.0, 'constraint_0': 50.0})
xs = np.linspace(0, 1, 400)
print('max err:', np.abs(hf.predict(xs).ravel()
                         - np.sin(2 * np.pi * k * xs)).max())
"""),
    md("""### A cheap accelerant for smooth problems

The inverse of the spectral-bias story: when the solution is SMOOTH,
layer-wise adaptive activations (`adaptive_activation=n`, L-LAAF) give
every activation slot one trainable slope `sigma(n*a*h)` and buy a
measured 3-11x lower residual loss at the same budget (README Poisson,
BENCHMARKS.md "Adaptive activations") for a handful of scalar
parameters.  It does NOT fix spectral bias — frequency content the net
can't see needs the embeddings above:"""),
    code("""
fast = Solver(pde, ndims=2, boundary_condition=1,
              layout='fa fa fa f', features=[10, 12, 15, 1],
              activation='Tanh', adaptive_activation=10.0, device=DEVICE)
fast.fit(batch_size=100, niters=1500)
print('final loss:', fast.losses[-1])  # ~3e-4 vs ~1.7e-3 plain
"""),
    md("""## 3D and beyond: separable PINNs

Pointwise collocation can't cover a 3D+ volume — `N**3` points cost
`N**3` network evaluations.  `SeparableModel` factorizes the solution
into one tiny MLP per axis (`u = Σ_r Π_i h_i(x_i)[r]`) and trains on the
tensor-product grid of per-axis samples, so `batch_size=32` means a
32³ = 32 768-point grid per iteration at three 32-row MLP evaluations.
Slice system components `f[..., k]`; evaluate dense grids with
`predict_grid`:"""),
    code("""
from pydens_tpu_torch import SeparableModel

def poisson3(f, x, y, z):
    return (D(D(f, x), x) + D(D(f, y), y) + D(D(f, z), z)
            + 3 * np.pi ** 2 * pdt.sin(np.pi * x) * pdt.sin(np.pi * y)
            * pdt.sin(np.pi * z))

sep = Solver(poisson3, ndims=3, boundary_condition=0.0,
             model=SeparableModel, layout='fa fa f',
             features=[32, 32, 32], activation='Tanh', device=DEVICE)
sep.fit(niters=300, batch_size=32, lr=2e-3)   # 300 x 32^3 points
g = np.linspace(0, 1, 33)
u = sep.predict_grid(g, g, g)[..., 0]         # dense grid: 3 axis evals
s = np.sin(np.pi * g)
true = s[:, None, None] * s[None, :, None] * s[None, None, :]
print('rel L2:', np.linalg.norm(u - true) / np.linalg.norm(true))
"""),
    md("""## Scaling out

On several cards, pass a mesh and the collocation batch shards over the
ranks, one a card (gradients all-reduce over NCCL automatically); a 2-D
mesh additionally shards ensemble members:

```python
from pydens_tpu_torch import make_mesh
solver = Solver(pde, ndims=2, boundary_condition=1, mesh=make_mesh())
solver = Solver(pde, ..., n_models=8,
                mesh=make_mesh(shape=(2, 4), axis_names=('models', 'data')))
```

To scale past one host, each process joins the cluster and runs the same
script over the global mesh (see `examples/18_distributed_data_parallel.py`):

```python
from pydens_tpu_torch.parallel import distributed
distributed.initialize()               # a launcher's env:// variables
solver = Solver(pde, ..., mesh=make_mesh())   # mesh spans ALL hosts
```

Checkpoint with `solver.save(path)` / `solver.load(path)`; resume an
optimizer with `fit(optimizer=None)`; profile with
`fit(profile_dir='/tmp/trace')`."""),
    md("""## Production guardrails

- A diverging fit (too-high learning rate, bad geometry batch) stops at
  the first non-finite loss — device-side, so a long compiled dispatch
  isn't burned — with a warning naming the iteration
  (`fit(stop_on_nan=False)` to disable).
- `predict` / `residual` / `predict_grad` take any batch size: nothing
  is compiled per shape, so sweeping grid sizes costs no recompile.
- Equations may use plain `np.*` math on the coordinate symbols
  (`np.cos(2 * np.pi * x)` stays symbolic and differentiable), the
  `pdt.*` twins, or `torch.*` (`torch.cos(2 * np.pi * x)`) — all
  equivalent.
- Long runs auto-checkpoint at chunk boundaries with
  `fit(checkpoint_path='state.npz')`; a crashed run resumes with
  `solver.load(...)` on a fresh process."""),
]


def main():
    write(CELLS, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "1_solving_pdes.ipynb"))


if __name__ == "__main__":
    main()
