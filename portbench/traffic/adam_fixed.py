"""``Solver.fit`` back to back with a first-order optimizer, each call full
batch on ONE fixed set of collocation points (``resample=False``), drawn at
the call by the program's own uniform product sampler over the
configuration's domain on the device (the solver's generator seeded from
the run's seed); the optimizer and its state carry on from call to call.

The configuration names its plain reference module (``reference``, in
``portbench/reference/``), which gives the parameters' leaf layout, their
init bounds and the steps the check follows: the model may embed its
input (a periodic column), so the layout is not ``pinn.py``'s.  The Solver
is built with the configuration's periodic columns and its initial
condition (the equation module's ``initial_condition``).

Parameters: ``batch_size``, ``optimizer``, ``lr``, ``chunk_size`` (steps a
call), ``stop_on_nan`` (the guard), ``trace_units`` (fit calls in the
traced window).
"""

import importlib

import numpy as np
import torch

from portbench import compare, inputs, program
from portbench.cell import Cell, tf32

FAULTS = ("state_unchanged", "half_batch")


def reference(config):
    """The configuration's plain reference module."""
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def solver(config, device, seed):
    """A Solver of the configuration, on ``device``; ``seed`` seeds its own
    sampling generator."""
    from pydens_tpu_torch import Solver
    eq = importlib.import_module(f"portbench.equations.{config['equation']}")
    return Solver(eq.build(), ndims=config["ndims"],
                  domain=[tuple(d) for d in config["domain"]],
                  periodic={int(d): int(m)
                            for d, m in config["periodic"].items()},
                  periodic_ic_decay=config["periodic_ic_decay"],
                  initial_condition=eq.initial_condition,
                  boundary_condition=config["boundary_condition"],
                  layout=config["layout"], activation=config["activation"],
                  units=list(config["units"]), device=device, seed=seed)


def sampler(config):
    """The program's uniform product sampler over the domain."""
    from pydens_tpu_torch import NumpySampler
    out = None
    for lo, hi in config["domain"]:
        col = NumpySampler("u", low=lo, high=hi)
        out = col if out is None else out & col
    return out


def leaf_norms(ref, config, flat):
    return np.array([float(torch.linalg.vector_norm(leaf.double()))
                     for leaf in ref.leaves(config, flat.detach())])


def norm_gap(ref, config, prog, want, keep):
    """``compare.norm_gap`` over the reference module's leaves: the worst
    kept leaf's ``|norm(prog) - norm(want)|`` over the larger of its
    reference norm and the median kept leaf's."""
    p = leaf_norms(ref, config, prog)[keep]
    r = leaf_norms(ref, config, want)[keep]
    gap, scale = np.abs(p - r), np.maximum(r, np.median(r))
    return float(np.max(np.where(scale > 0, gap / np.where(scale > 0, scale,
                                                              1.0),
                                 np.where(gap > 0, 1.0, 0.0))))


class Traffic(Cell):
    def prepare(self):
        cfg, p, seed = self.config, self.params, self.ctx.seed
        self.ref = reference(cfg)
        self.solver = solver(cfg, self.device,
                             inputs.substream(seed, inputs.POINTS))
        self.draws = program.Draws(self.solver)
        self.sampler = sampler(cfg)
        # The check's weights (a stream of their own), loaded.
        bounds = self.ref.init_bounds(cfg, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            inputs.substream(seed, inputs.CHECK_WEIGHTS))
        self.theta0 = (2 * torch.rand(bounds.shape, generator=gen,
                                      device=self.device) - 1) * bounds
        self.solver.model.load_params(self.tree(self.theta0))
        # Three steps through the window's arguments: one, then two with
        # the optimizer and its state carried on; each call draws its fixed
        # batch, so the steps train on the first draw, then twice on the
        # second.
        start = len(self.solver.losses)
        self.draws.take(2)
        self.fit(1, optimizer=p["optimizer"], lr=p["lr"])
        self.state1 = program.optimizer_state(self.solver)
        self.fit(2, optimizer=None)
        self.theta3 = self.flat_params()
        self.losses = list(self.solver.losses[start:start + 3])
        one, two = self.draws.batches()
        self.batches = [one, two, two]
        self.steps = 0

    def tree(self, theta):
        """``theta`` as the nested parameter tree ``Model.load_params``
        takes."""
        out = {"net": {}, "variables": {}}
        for path, leaf in self.ref.unflatten(self.config, theta).items():
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    def flat_params(self):
        """The model's parameters as a flat vector in the reference's
        order."""
        params = self.solver.model.params
        parts = []
        for path, _ in self.ref.leaf_layout(self.config):
            node = params
            for key in path:
                node = node[key]
            parts.append(node.detach().reshape(-1))
        return torch.cat(parts).clone()

    def fit(self, niters, **kwargs):
        p = self.params
        self.solver.fit(niters=niters, batch_size=p["batch_size"],
                        sampler=self.sampler, chunk_size=p["chunk_size"],
                        resample=False, stop_on_nan=p["stop_on_nan"],
                        progress=False, **kwargs)

    def warm(self):
        self.fit(self.params["chunk_size"], optimizer=None)

    def window_begin(self):
        self.steps = 0

    def unit(self):
        self.fit(self.params["chunk_size"], optimizer=None)
        record = self.solver.history[-1]
        self.steps += record["niters"]
        return {"failed": "stopped_on_nan" in record}

    def end_to_end(self, window_s):
        return {"fit_points_per_s":
                self.steps * self.params["batch_size"] / window_s}

    def trace_facts(self):
        return {"steps": self.steps, "points": self.params["batch_size"],
                "step_kind": "first_order"}

    def judge(self, control=False):
        """``loss_gap``, ``grad_gap`` (the first gradient as Adam got it:
        its first moment after one step over ``1 - b1``) and ``change_gap``
        (the parameters' change after three steps), as ``adam_fit``'s."""
        cfg, ref, lr = self.config, self.ref, self.params["lr"]
        want = ref.adam_steps(cfg, self.theta0, self.batches, lr)
        if control:
            with tf32(True):
                losses, grad, theta3 = ref.adam_steps(cfg, self.theta0,
                                                      self.batches, lr)
        else:
            losses, theta3 = self.losses, self.theta3
            grad = torch.as_tensor(self.state1["mu"]).to(
                self.theta0.device) / (1 - ref.ADAM_B1)
        norms = leaf_norms(ref, cfg, want[1])
        keep = np.flatnonzero(norms >= compare.NEGLIGIBLE * np.median(norms))
        return {
            "loss_gap": compare.loss_gap(losses, want[0]),
            "grad_gap": norm_gap(ref, cfg, grad, want[1], keep),
            "change_gap": norm_gap(ref, cfg, theta3 - self.theta0,
                                   want[2] - self.theta0, keep)}
