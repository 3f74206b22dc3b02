"""The program under test, as the benchmark drives it: a
``pydens_tpu_torch.Solver`` built from a configuration file, and readings
of its state through its public surface."""

import contextlib
import importlib
import os
import tempfile

import numpy as np
import torch

from portbench import inputs
from portbench.reference import pinn


def solver(config, device, seed):
    """A Solver of the configuration, on ``device``; ``seed`` seeds its own
    sampling generator (the points of its default U(0, 1) sampler)."""
    from pydens_tpu_torch import Solver
    eq = importlib.import_module(f"portbench.equations.{config['equation']}")
    return Solver(eq.build(), ndims=config["ndims"],
                  boundary_condition=config["boundary_condition"],
                  domain=[tuple(d) for d in config["domain"]],
                  layout=config["layout"], activation=config["activation"],
                  units=list(config["units"]), device=device, seed=seed)


class Draws:
    """Watches the points the solver's own sampler draws (``Solver._sample``
    is wrapped on this one instance; what it returns is passed on as it
    is): each draw's first ``rows`` batches are kept while ``armed`` is
    above 0, for the reference, which trains on the same points."""

    def __init__(self, solver, rows=3):
        self.draw = getattr(solver, "_sample", None)
        if self.draw is None:
            raise RuntimeError("the program's sampler draws cannot be "
                               "watched: Solver has no _sample")
        self.rows = rows
        self.armed = 0
        self.kept = []
        solver._sample = self

    def __call__(self, sampler, n, batch_size):
        pts = self.draw(sampler, n, batch_size)
        if self.armed > 0:
            self.armed -= 1
            self.kept.append(pts[:self.rows].detach().clone())
        return pts

    def take(self, count):
        """Keep the next ``count`` draws from now on."""
        self.kept, self.armed = [], count
        return self

    def batches(self):
        """The kept draws' batches, one ``(batch, ndims)`` a step."""
        return [b for pts in self.kept for b in pts]


@contextlib.contextmanager
def first_linearization():
    """Inside the block, the first Levenberg-Marquardt linearization the
    program makes (``pydens_tpu_torch.utils.optimizers.linearize``, which
    ``LMConfig.update`` calls once a step) is watched: the dict it yields
    gets that step's residual vector ``r`` and ``J^T r`` (``jtr``), the
    first CG direction ``v`` with ``J v`` (``jv``, the tangent kernel's on
    the card) and the first ``w`` with ``J^T w`` (``jtw``).  What the
    program computes is passed on as it is."""
    from pydens_tpu_torch.utils import optimizers
    linearize, seen = optimizers.linearize, {}

    def watched(residual_fn, theta):
        r, jtr, jvp, vjp = linearize(residual_fn, theta)
        if seen:
            return r, jtr, jvp, vjp
        seen.update(r=r.clone(), jtr=jtr.clone())

        def jvp_(v):
            out = jvp(v)
            if "jv" not in seen:
                seen.update(v=v.detach().clone(), jv=out.detach().clone())
            return out

        def vjp_(w):
            out = vjp(w)
            if "jtw" not in seen:
                seen.update(w=w.detach().clone(), jtw=out.detach().clone())
            return out
        return r, jtr, jvp_, vjp_

    optimizers.linearize = watched
    try:
        yield seen
    finally:
        optimizers.linearize = linearize


def load(solver, config, theta):
    """Load the benchmark's flat ``theta`` into the solver's model."""
    solver.model.load_params(inputs.tree(config, theta))


def flat_params(solver, config):
    """The model's parameters as a flat vector in the reference's order."""
    params = solver.model.params
    parts = []
    for path, _ in pinn.leaf_layout(config):
        node = params
        for key in path:
            node = node[key]
        parts.append(node.detach().reshape(-1))
    return torch.cat(parts).clone()


def optimizer_state(solver):
    """The optimizer state as ``Solver.save`` writes it: ``{name: array}``
    (flat buffers in the sorted-path order of the parameter tree)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        solver.save(path)
        with np.load(path) as data:
            return {k[len("opt_state/"):]: np.array(data[k])
                    for k in data.files if k.startswith("opt_state/")}
