"""``Solver.predict`` requests back to back from one client, each one
stacked ``(points, ndims)`` float32 numpy lattice; the requests cycle
through ``grids`` lattices made before the window from the seed, so that
no two successive requests are alike.  A reservoir sample of ``judged``
answers, drawn from the seed over every request of the window, is
compared once the window has closed.

Parameters: ``grid_side`` (points = grid_side ** ndims), ``grids``,
``judged``, ``trace_units`` (requests in the traced window).
"""

import time

import numpy as np
import torch

from portbench import compare, inputs, program
from portbench.cell import Cell, tf32
from portbench.reference import pinn


FAULTS = ("answer_altered",)


class Traffic(Cell):
    def prepare(self):
        cfg, p, seed = self.config, self.params, self.ctx.seed
        self.build(inputs.substream(seed, inputs.POINTS))
        self.theta = inputs.weights(cfg, seed, inputs.WEIGHTS, 1,
                                    self.device)[0]
        program.load(self.solver, cfg, self.theta)
        self.grids = inputs.grids(seed, p["grids"], p["grid_side"],
                                  cfg["ndims"])
        self.rng = np.random.default_rng(inputs.substream(seed,
                                                          inputs.SAMPLE))
        self.sample = []
        self.requests = 0

    def warm(self):
        for grid in self.grids[:2]:
            self.solver.predict(grid)

    def window_begin(self):
        self.latencies = []

    def unit(self):
        j = self.requests
        self.requests += 1
        g = j % len(self.grids)
        t0 = time.perf_counter()
        u = self.solver.predict(self.grids[g])
        self.latencies.append(time.perf_counter() - t0)
        # Reservoir sampling: every request so far equally likely kept.
        k = self.params["judged"]
        if len(self.sample) < k:
            self.sample.append((g, u))
        else:
            slot = self.rng.integers(0, j + 1)
            if slot < k:
                self.sample[slot] = (g, u)
        return {"failed": False}

    def end_to_end(self, window_s):
        lat = np.asarray(self.latencies)
        return {"predict_points_per_s":
                len(lat) * self.grids[0].shape[0] / window_s,
                "predict_ms_p95": float(np.percentile(lat, 95)) * 1e3}

    def trace_facts(self):
        return {"requests": len(self.latencies),
                "points": self.grids[0].shape[0]}

    def judge(self, control=False):
        """``predict_gap``: the sampled answers against the reference's
        solution at the benchmark's weights."""
        gaps = []
        for g, u in self.sample:
            pts = torch.as_tensor(self.grids[g], device=self.device)
            ref = pinn.predict(self.config, self.theta, pts)
            if control:
                with tf32(True):
                    u = pinn.predict(self.config, self.theta,
                                     pts).cpu().numpy()
            gaps.append(compare.answer_gap(u, ref))
        return {"predict_gap": max(gaps) if gaps else float("inf")}
