"""The data-parallel scenarios of tests/test_torch_parallel.py: each runs
the same fits on a mesh of ranks (``run_group``, in every rank of a gloo
group) and in one process without a mesh (``run_single``), the cases of
tests/test_parallel.py, test_mesh_feature_matrix.py, test_distributed.py,
test_gauss_newton.py and test_separable.py at their sizes or below.  A
scenario returns a JSON-able dict; it imports torch, never jax."""

import os
import sys
import warnings

import numpy as np
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import D, Solver, SeparableModel

RANKS = 4
CPU = dict(device="cpu")
NET = dict(activation="Tanh", layout="fafaf", features=[12, 10, 1])
SMALL = dict(activation="Tanh", layout="fa fa f", features=[16, 16, 1])


def _ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)


def _advection(f, x, t):
    return D(f, t) + 0.5 * D(f, x)


def _poisson2(f, x, y):
    return (D(D(f, x), x) + D(D(f, y), y)
            + 2 * np.pi ** 2 * torch.sin(np.pi * x) * torch.sin(np.pi * y))


def _mesh(kind):
    if kind is None:
        return None
    if kind == "data":
        return pdt.make_mesh(device="cpu")
    return pdt.make_mesh(shape=(2, 2), axis_names=kind, device="cpu")


def _losses(s):
    return [float(v) for v in s.losses]


def _data1d(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh,
               **NET, **CPU)
    s.fit(niters=100, batch_size=256, lr=0.02, progress=False)
    return dict(losses=_losses(s),
                pred=s.predict(np.linspace(0, 1, 50)).ravel().tolist())


def _samplers(mesh):
    s = Solver(lambda f, x, e: D(f, x) - e, ndims=1, nparams=1,
               initial_condition=0.0, seed=0, mesh=mesh, **CPU)
    s.fit(niters=20, batch_size=64, sampler=pdt.NS("u") & pdt.NS(
        "u", low=1, high=5), progress=False)
    h = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh, **CPU)
    h.fit(niters=10, batch_size=64,
          sampler=pdt.ScipySampler("uniform", seed=0), progress=False)
    return dict(device=_losses(s), host=_losses(h))


def _ensemble(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh,
               n_models=4, **NET, **CPU)
    s.fit(niters=100, batch_size=256, lr=0.02, progress=False)
    xs = np.linspace(0, 1, 9)
    return dict(losses=_losses(s), all=s.predict_all(xs).tolist(),
                std=s.predict_std(xs).ravel().tolist(),
                theta=s._spec().flatten(s.model.params).ravel().tolist())


def _dcn(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh,
               **NET, **CPU)
    s.fit(niters=100, batch_size=256, lr=0.02, progress=False)
    return dict(losses=_losses(s),
                rows=next(iter(s._step_cache.values())).points.shape[1])


def _until(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh,
               **SMALL, **CPU)
    s.fit(niters=4000, batch_size=256, lr=0.02, chunk_size=200,
          until_loss=5e-2, progress=False)
    return dict(losses=_losses(s),
                converged_at=s.history[-1].get("converged_at"))


def _guard(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh, **CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s.fit(niters=400, batch_size=64, chunk_size=50, optimizer="SGD",
              lr=1e2, progress=False)
    return dict(stopped=s.history[-1].get("stopped_on_nan"),
                n=len(s.losses),
                warned=any("non-finite" in str(w.message) for w in caught))


def _feature(equation, fit, **kw):
    def run(mesh):
        s = Solver(equation, seed=0, mesh=mesh, **SMALL, **kw, **CPU)
        s.fit(progress=False, **fit)
        return dict(losses=_losses(s),
                    weights=s.history[-1].get("balanced_weights"))
    return run


_ADVECTION = dict(ndims=2, initial_condition=lambda x: torch.sin(np.pi * x))
_CONSTRAINED = dict(ndims=1, initial_condition=0.5,
                    constraints=lambda f, x: f(np.full(4, 0.25)) - 1.0)


def _lm(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh, **CPU)
    s.fit(niters=10, batch_size=128, optimizer="LM", resample=False,
          progress=False)
    return dict(losses=_losses(s))


def _lbfgs(mesh):
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0, mesh=mesh,
               **NET, **CPU)
    s.fit(niters=200, batch_size=128, lr=0.02, progress=False)
    s.fit(niters=10, batch_size=128, optimizer="LBFGS", resample=False,
          progress=False)
    return dict(losses=_losses(s))


def _separable(mesh):
    s = Solver(_poisson2, ndims=2, boundary_condition=0.0,
               model=SeparableModel, layout="fa f", features=[16, 8],
               seed=0, mesh=mesh, **CPU)
    s.fit(niters=40, batch_size=16, progress=False)
    s.fit(niters=3, batch_size=16, optimizer="LM", resample=False,
          progress=False)
    return dict(losses=_losses(s))


def _allen_cahn(f, x, t):
    # examples/28's equation: time on grid axis 1, the initial condition.
    return D(f, t) - 1e-4 * D(D(f, x), x) - 5.0 * (f - f ** 3)


def _reaction(f, t, x):
    # Time first: on a mesh grid axis 0, the split one, is time.
    return D(f, t) - 0.05 * D(D(f, x), x) - f * (1.0 - f ** 2)


# The causal separable cases: (equation, Solver keywords, causal_axis);
# examples/28 at a narrow width, and time on the split grid axis.
SEPARABLE_CAUSAL = {
    "separable_causal": (_allen_cahn, dict(
        ndims=2, domain=[(-1, 1), (0, 1)],
        initial_condition=lambda x: x ** 2 * torch.cos(np.pi * x),
        periodic={0: 3}, periodic_ic_decay=False), None),
    "separable_causal_t0": (_reaction, dict(
        ndims=2, boundary_condition=0.0), 0),
}
SEPARABLE_NET = dict(layout="fa fa f", features=[12, 12, 8],
                     activation="Tanh")
CAUSAL_EPS = 5.0            # the parity case's temperature


def _separable_causal(name):
    equation, kw, t_axis = SEPARABLE_CAUSAL[name]

    def run(mesh):
        s = Solver(equation, model=SeparableModel, seed=0, mesh=mesh, **kw,
                   **SEPARABLE_NET, **CPU)
        for eps in (1.0, 5.0):   # annealed, as examples/28
            s.fit(niters=20, batch_size=16, causal=eps, causal_axis=t_axis,
                  progress=False)
        return dict(losses=_losses(s))
    return run


SCENARIOS = {
    "data1d": ("data", _data1d),
    "samplers": ("data", _samplers),
    "models_data": (("models", "data"), _ensemble),
    "dcn_data": (("dcn", "data"), _dcn),
    "until_loss": ("data", _until),
    "guard": ("data", _guard),
    "adaptive": ("data", _feature(_ode, dict(
        niters=60, batch_size=64, lr=0.02, adaptive=4), ndims=1,
        initial_condition=0.5)),
    "rba": ("data", _feature(_advection, dict(
        niters=60, batch_size=64, resample=False, rba=True), **_ADVECTION)),
    "causal": ("data", _feature(_advection, dict(
        niters=60, batch_size=64, causal=5.0), **_ADVECTION)),
    "ntk": ("data", _feature(_ode, dict(
        niters=60, batch_size=64, loss_balancing=("ntk", 10),
        loss_terms=["equation", "constraint_0"]), **_CONSTRAINED)),
    "grad_balancing": ("data", _feature(_ode, dict(
        niters=60, batch_size=64, loss_balancing=("grad", 10),
        loss_terms=["equation", "constraint_0"]), **_CONSTRAINED)),
    "lm": ("data", _lm),
    "lbfgs": ("data", _lbfgs),
    "separable": ("data", _separable),
    "separable_causal": ("data", _separable_causal("separable_causal")),
    "separable_causal_t0": ("data", _separable_causal("separable_causal_t0")),
}


def run_single():
    """Every scenario in this process, without a mesh."""
    return {name: fn(None) for name, (_, fn) in SCENARIOS.items()}


def _errors():
    """The mesh checks' messages, each rank's."""
    out = {}
    mesh = pdt.make_mesh(device="cpu")
    s = Solver(_ode, ndims=1, mesh=mesh, seed=0, **CPU)
    for key, call in (
            ("batch", lambda: s.fit(niters=1, batch_size=10,
                                    progress=False)),
            ("n_models", lambda: Solver(
                _ode, ndims=1, seed=0, n_models=3, mesh=_mesh(
                    ("models", "data")), **CPU).fit(
                niters=1, batch_size=8, progress=False)),
            ("data_axes", lambda: Solver(
                _ode, ndims=1, seed=0, n_models=2, mesh=_mesh(
                    ("models", "data")), **CPU).fit(
                niters=1, batch_size=5, progress=False)),
            ("dcn_total", lambda: Solver(
                _ode, ndims=1, seed=0, mesh=_mesh(("dcn", "data")),
                **CPU).fit(niters=1, batch_size=6, progress=False)),
            ("axis_names", lambda: pdt.make_mesh(shape=(2, 2),
                                                 device="cpu")),
            ("shape_devices", lambda: pdt.make_mesh(
                shape=(4, 4), axis_names=("models", "data"), device="cpu")),
            ("n_devices", lambda: pdt.make_mesh(100, device="cpu"))):
        try:
            call()
            out[key] = None
        except ValueError as err:
            out[key] = f"{type(err).__name__}: {err}"
    out["subset_size"] = pdt.make_mesh(2, device="cpu").size()
    return out


def _checkpoint(mesh, out_dir, rank):
    """One writer: only the mesh's first rank writes ``checkpoint_path``
    (each rank names its own file); every rank loads rank 0's, and the
    restored continuation equals the saving solver's."""
    path = os.path.join(out_dir, f"ckpt.p{rank}")
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=7, mesh=mesh,
               **NET, **CPU)
    s.fit(niters=20, batch_size=64, lr=0.02, chunk_size=10,
          checkpoint_path=path, progress=False)
    written = sorted(f for f in os.listdir(out_dir)
                     if f.startswith("ckpt.p") and not f.endswith(".tmp"))
    s.fit(niters=10, batch_size=64, lr=0.02, chunk_size=10,
          optimizer=None, progress=False)
    r = Solver(_ode, ndims=1, initial_condition=.5, seed=13, mesh=mesh,
               **NET, **CPU)
    r.load(os.path.join(out_dir, "ckpt.p0"))
    n_loaded = len(r.losses)
    r.fit(niters=10, batch_size=64, lr=0.02, chunk_size=10, progress=False)
    return dict(written=written, n_loaded=n_loaded,
                resumed=_losses(r)[20:], saving=_losses(s)[20:])


def _load_tree(data):
    """A parameter tree from ``name/leaf`` keys of an npz (``pts``
    aside)."""
    tree = {}
    for name in data.files:
        if name == "pts":
            continue
        node = tree
        *head, leaf = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = data[name]
    tree.setdefault("variables", {})
    return tree


def _jax_parity(out_dir):
    """Loss and flat gradient at a fixed theta (pydens_tpu's, from
    ``jax_theta.npz``) on a fixed batch of 64 points, on the mesh: each rank
    its 16 rows, summed over the ranks."""
    from pydens_tpu_torch import params_from_jax
    from pydens_tpu_torch.utils.criteria import mse_loss
    data = np.load(os.path.join(out_dir, "jax_theta.npz"))
    s = Solver(_ode, ndims=1, initial_condition=.5, seed=0,
               mesh=pdt.make_mesh(device="cpu"), **NET, **CPU)
    s.model.load_params(params_from_jax(_load_tree(data)))
    loss_fn = s._build_loss_fn((("equation", 1.0),), mse_loss,
                               use_plan=True)
    theta = loss_fn.spec.flatten(s.model.params).detach().requires_grad_()
    pts = s._shards.shard(torch.from_numpy(data["pts"]))
    loss = loss_fn(theta, pts)
    grad, = torch.autograd.grad(loss, theta)
    loss, grad = s._shards.share_sum(loss.detach(), grad)
    return dict(loss=float(loss), grad=grad.tolist(), rows=pts.shape[0])


def _jax_parity_causal(out_dir, name):
    """The causal separable loss and flat gradient at pydens_tpu's theta
    (``jax_<name>.npz``) on its fixed grid batch, on the mesh: each rank
    its rows of grid axis 0, the slice means made global by one
    all-reduce, loss and gradient summed over the ranks."""
    from pydens_tpu_torch import params_from_jax
    from pydens_tpu_torch.parallel.shards import Shards
    from pydens_tpu_torch.utils.criteria import mse_loss
    equation, kw, t_axis = SEPARABLE_CAUSAL[name]
    data = np.load(os.path.join(out_dir, f"jax_{name}.npz"))
    s = Solver(equation, model=SeparableModel, seed=0,
               mesh=pdt.make_mesh(device="cpu"), **kw, **SEPARABLE_NET,
               **CPU)
    s.model.load_params(params_from_jax(_load_tree(data)))
    t_idx = s.model.ndims - 1 if t_axis is None else t_axis
    lo, hi = s.model.domain[t_idx]
    loss_fn = s._build_loss_fn((("equation", 1.0),), mse_loss,
                               causal=(t_idx, float(lo), float(hi)))
    theta = loss_fn.spec.flatten(s.model.params).detach().requires_grad_()
    before = Shards.collectives
    loss = loss_fn(theta, torch.from_numpy(data["pts"]),
                   causal_eps=torch.tensor(CAUSAL_EPS))
    grad, = torch.autograd.grad(loss, theta)
    issued = Shards.collectives - before
    loss, grad = s._shards.share_sum(loss.detach(), grad)
    return dict(loss=float(loss), grad=grad.tolist(), collectives=issued)


def run_group(rank, out_dir):
    """Every scenario on this rank of the group, and the checks."""
    import time
    out = {"world": torch.distributed.get_world_size(), "seconds": {}}
    for name, (kind, fn) in SCENARIOS.items():
        t0 = time.perf_counter()
        out[name] = fn(_mesh(kind))
        out["seconds"][name] = time.perf_counter() - t0
    out["errors"] = _errors()
    out["checkpoint"] = _checkpoint(_mesh("data"), out_dir, rank)
    out["jax_parity"] = _jax_parity(out_dir)
    out["jax_parity_causal"] = {name: _jax_parity_causal(out_dir, name)
                                for name in SEPARABLE_CAUSAL}
    return out


def main():
    import json
    rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    pdt.parallel.distributed.initialize(f"localhost:{port}", RANKS, rank,
                                        device="cpu")
    out = run_group(rank, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
