"""Whole solves back to back, each the README's: ``Solver.reset``, the
benchmark's weights of the solve, ``fit(niters, batch_size)`` with the
fit's defaults (the default U(0, 1)^d sampler, drawing from the solver's
generator, which the solve's ``reset`` seeds from the run's seed), then
``predict`` on the README's lattice in its two-column form.  A solve
fails when its fit stops on a NaN or its final loss or answer is not
finite.  ``solve_s`` is the window over the solves that met the README's
own check (final loss below ``loss_below``): a solve that misses it is a
sound answer to a harder start, not a failed one, and its time stays in
the window without it.

Parameters: ``niters``, ``batch_size``, ``lr`` (the fit's default, for
the reference), ``grid_side`` (the predict lattice), ``loss_below``,
``weights`` (distinct initial weights, reused in turn), ``judged``
(solves of the window that are compared), ``trace_units`` (solves in the
traced window).
"""

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, inputs, program
from portbench.cell import Cell, FirstSteps, first_step_weights, tf32
from portbench.reference import pinn


FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "reset_keeps_state")


class Traffic(Cell):
    def prepare(self):
        cfg, p, seed = self.config, self.params, self.ctx.seed
        self.build(inputs.substream(seed, inputs.CHECK_POINTS))
        check = first_step_weights(self, 2)
        self.first = FirstSteps(self, check[0], self.fit, {})
        self.warm_theta = check[1]
        self.thetas = inputs.weights(cfg, seed, inputs.WEIGHTS,
                                     p["weights"], self.device)
        xs = np.linspace(0, 1, p["grid_side"], dtype=np.float32)
        self.grid = np.stack(np.meshgrid(xs, xs, indexing="ij"),
                             -1).reshape(-1, 2)
        self.done = []
        self.index = 0

    def fit(self, niters, **kwargs):
        self.solver.fit(niters=niters, batch_size=self.params["batch_size"],
                        progress=False, **kwargs)

    def solve(self, theta, points_seed):
        """One README solve; returns its predicted lattice and its first
        three losses."""
        with record_function("portbench.solve"):
            self.solver.reset(seed=points_seed)
            program.load(self.solver, self.config, theta)
            self.draws.take(1)
            start = len(self.solver.losses)
            with record_function("portbench.fit"):
                self.fit(self.params["niters"])
            u = self.solver.predict(self.grid[:, 0:1], self.grid[:, 1:2])
        return u, self.solver.losses[start:start + 3]

    def warm(self):
        self.solve(self.warm_theta, inputs.substream(self.ctx.seed,
                                                     inputs.CHECK_POINTS, 1))

    def window_begin(self):
        self.solves = self.passed = 0

    def unit(self):
        i = self.index
        self.index += 1
        theta = self.thetas[i % len(self.thetas)]
        u, losses = self.solve(theta, inputs.substream(
            self.ctx.seed, inputs.POINTS, i))
        final = self.solver.losses[-1]
        broken = ("stopped_on_nan" in self.solver.history[-1]
                  or not np.isfinite(final) or not np.isfinite(u).all())
        self.done.append(dict(
            theta=theta, losses=losses, batches=self.draws.batches(), u=u,
            final=program.flat_params(self.solver, self.config)))
        self.solves += 1
        self.passed += int(final < self.params["loss_below"])
        return {"failed": broken}

    def end_to_end(self, window_s):
        return {"solve_s": window_s / max(self.passed, 1)}

    def trace_facts(self):
        return {"steps": self.solves * self.params["niters"],
                "points": self.params["batch_size"],
                "step_kind": "first_order"}

    def judge(self, control=False):
        """The fresh solver's first three steps' numbers, and of a sample of
        the window's solves: ``window.loss_gap``, each sampled solve's first
        three losses (after its ``reset`` and load, on the points its
        sampler drew) against the reference's three Adam steps from the
        solve's weights, and ``predict_gap``, its predicted lattice against
        the reference's solution at the solve's final parameters (the
        reference cannot follow 1,500 float32 Adam steps of the program:
        their start is checked, and the answer at the program's end)."""
        p = self.params
        out = self.first.adam_numbers(p["lr"], tf32_control=control)
        rng = np.random.default_rng(inputs.substream(self.ctx.seed,
                                                     inputs.SAMPLE))
        pick = rng.choice(len(self.done), min(p["judged"], len(self.done)),
                          replace=False)
        grid = torch.as_tensor(self.grid, device=self.device)
        loss_gaps, gaps = [], []
        for i in pick:
            d = self.done[i]
            ref, _, _ = pinn.adam_steps(self.config, d["theta"],
                                        d["batches"], p["lr"])
            ref_u = pinn.predict(self.config, d["final"], grid)
            losses, u = d["losses"], d["u"]
            if control:
                with tf32(True):
                    losses, _, _ = pinn.adam_steps(
                        self.config, d["theta"], d["batches"], p["lr"])
                    u = pinn.predict(self.config, d["final"],
                                     grid).cpu().numpy()
            loss_gaps.append(compare.loss_gap(losses, ref))
            gaps.append(compare.answer_gap(u, ref_u))
        inf = float("inf")
        out["window.loss_gap"] = max(loss_gaps) if loss_gaps else inf
        out["predict_gap"] = max(gaps) if gaps else inf
        return out
