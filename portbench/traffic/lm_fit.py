"""The README ladder's finisher: Levenberg-Marquardt ``Solver.fit(
optimizer='LM')`` back to back, each call on a fixed batch of points from
the solver's default U(0, 1)^d sampler, drawn on the device at the call
(``resample=False``), the damping carried on from call to call.  Set-up
first trains the benchmark's weights with ``adam_steps`` Adam steps (the
ladder's first rung, fresh points each step), as users start a finisher.

The check covers both stages.  The Adam stage's first three steps are
compared as in ``adam_fit``; the reference cannot follow the program's
``adam_steps`` float32 steps, so the first three LM steps are compared
from the parameters the program's Adam stage left (the program's state,
read through ``Solver.params``), and so are the products the first LM step
makes (``J^T r``, ``J v``, ``J^T w``: the backward and tangent kernels on
the card), watched as the program computes them
(``program.first_linearization``).

Parameters: ``batch_size``, ``adam_steps``, ``adam_lr``, ``chunk_size``
(the Adam stage's), ``cg_iters``, ``steps_per_fit`` (steps of one call,
its chunk), ``stop_on_nan``, ``trace_units`` (fit calls in the traced
window).
"""

from portbench import compare, inputs, program
from portbench.cell import Cell, FirstSteps, first_step_weights, tf32
from portbench.reference import pinn

FAULTS = ("state_unchanged", "half_batch", "tangent_off")


class Traffic(Cell):
    def prepare(self):
        cfg, p, seed = self.config, self.params, self.ctx.seed
        self.build(inputs.substream(seed, inputs.POINTS))
        self.adam = FirstSteps(self, first_step_weights(self)[0],
                               self.adam_fit, dict(optimizer="Adam",
                                                   lr=p["adam_lr"]))
        self.adam_fit(p["adam_steps"] - 3, optimizer=None)
        with program.first_linearization() as self.products:
            self.first = FirstSteps(
                self, program.flat_params(self.solver, cfg), self.fit,
                dict(optimizer="LM", cg_iters=p["cg_iters"]), load=False)
        # resample=False: a call draws one batch and trains on it.
        one, two = self.first.batches
        self.first.batches = [one, two, two]
        self.steps = 0
        self.lives = []

    def adam_fit(self, niters, **kwargs):
        p = self.params
        self.solver.fit(niters=niters, batch_size=p["batch_size"],
                        chunk_size=p["chunk_size"],
                        stop_on_nan=p["stop_on_nan"], progress=False,
                        **kwargs)

    def fit(self, niters, **kwargs):
        p = self.params
        self.solver.fit(niters=niters, batch_size=p["batch_size"],
                        chunk_size=niters, resample=False,
                        stop_on_nan=p["stop_on_nan"], progress=False,
                        **kwargs)

    def warm(self):
        self.fit(self.params["steps_per_fit"], optimizer=None)

    def window_begin(self):
        self.steps = 0

    def unit(self):
        self.fit(self.params["steps_per_fit"], optimizer=None)
        record = self.solver.history[-1]
        self.steps += record["niters"]
        return {"failed": "stopped_on_nan" in record}

    def end_to_end(self, window_s):
        return {"lm_fit_points_per_s":
                self.steps * self.params["batch_size"] / window_s}

    def trace_facts(self):
        return {"steps": self.steps, "points": self.params["batch_size"],
                "step_kind": "lm"}

    def reference_facts(self):
        """The live CG iterations the checked steps' inputs need, by the
        reference's CG: what ``mfu.fit`` counts an LM step at."""
        if not self.lives:
            return {}
        return {"live_cg_per_step": sum(self.lives) / len(self.lives)}

    def judge(self, control=False):
        """The Adam stage's ``adam.*`` numbers, and the LM stage's:
        ``lm.loss1_gap`` (the loss the first LM step starts from),
        ``lm.jtr_gap`` and ``lm.vjp_gap`` (``J^T r`` and the first ``J^T
        w``, by leaf as ``grad_gap``), ``lm.jvp_gap`` (the first ``J v``,
        relative in the residual's space) and ``lm.change_gap`` (three
        steps' change).  The later steps' losses and the first step's
        change follow where float32 CG ends after 50 iterations, and are
        not compared (``PERF.md`` gives why); LM's state holds its damping,
        not a gradient."""
        cfg, f, seen = self.config, self.first, self.products
        out = {f"adam.{k}": v for k, v in self.adam.adam_numbers(
            self.params["adam_lr"], tf32_control=control).items()}
        cg = self.params["cg_iters"]
        losses_r, grad_r, thetas_r, self.lives = pinn.lm_steps(
            cfg, f.theta0, f.batches, cg)
        keep = compare.kept_leaves(cfg, grad_r)
        losses, theta3 = f.losses, f.theta3
        inf = float("inf")
        n = f.batches[0].shape[0]
        if ({"jtr", "v", "jv", "w", "jtw"} <= set(seen)
                and seen["w"].shape == seen["jv"].shape == (n,)):
            ref = pinn.lm_products(cfg, f.theta0, f.batches[0], seen["v"],
                                   seen["w"])
            prog = seen["jtr"], seen["jv"], seen["jtw"]
            if control:
                with tf32(True):
                    prog = pinn.lm_products(cfg, f.theta0, f.batches[0],
                                            seen["v"], seen["w"])
            out.update({
                "lm.jtr_gap": compare.norm_gap(cfg, prog[0], ref[0], keep),
                "lm.jvp_gap": compare.relative_gap(prog[1], ref[1]),
                "lm.vjp_gap": compare.norm_gap(cfg, prog[2], ref[2],
                                               keep)})
        else:   # no linearization the check could watch, or not over the
            # batch's points
            out.update({"lm.jtr_gap": inf, "lm.jvp_gap": inf,
                        "lm.vjp_gap": inf})
        if control:
            with tf32(True):
                losses, _, thetas, _ = pinn.lm_steps(cfg, f.theta0,
                                                     f.batches, cg)
            theta3 = thetas[-1]
        out.update({
            "lm.loss1_gap": compare.loss_gap(losses[:1], losses_r[:1]),
            "lm.change_gap": compare.norm_gap(cfg, theta3 - f.theta0,
                                              thetas_r[-1] - f.theta0,
                                              keep)})
        return out
