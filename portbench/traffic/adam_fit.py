"""``Solver.fit`` back to back with a first-order optimizer, a fresh batch
of points a step from the solver's default U(0, 1)^d sampler, drawn on the
device (its generator seeded from the run's seed), one chunk a call; the
optimizer and its state carry on from call to call.

Parameters: ``batch_size``, ``optimizer``, ``lr``, ``chunk_size``,
``stop_on_nan`` (the guard), ``trace_units`` (fit calls in the traced
window).
"""

from portbench import inputs
from portbench.cell import Cell, FirstSteps, first_step_weights


FAULTS = ("state_unchanged", "half_batch")


class Traffic(Cell):
    def prepare(self):
        p, seed = self.params, self.ctx.seed
        self.build(inputs.substream(seed, inputs.POINTS))
        self.first = FirstSteps(self, first_step_weights(self)[0], self.fit,
                                dict(optimizer=p["optimizer"], lr=p["lr"]))
        self.steps = 0

    def fit(self, niters, **kwargs):
        p = self.params
        self.solver.fit(niters=niters, batch_size=p["batch_size"],
                        chunk_size=p["chunk_size"],
                        stop_on_nan=p["stop_on_nan"], progress=False,
                        **kwargs)

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
        return self.first.adam_numbers(self.params["lr"],
                                       tf32_control=control)
