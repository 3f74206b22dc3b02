"""What every traffic kind shares: the cell's context and the check of a
training step's first three steps against the reference.

A traffic kind is a module ``portbench/traffic/<kind>.py`` with a class
``Traffic(Cell)`` that gives:

* ``prepare()``: build the program and the inputs, and drive the program
  through what the check compares (set-up);
* ``warm()``: warm up every shape the window uses (set-up);
* ``window_begin()`` and ``unit()``: one unit of the closed loop (a fit
  call, a solve, a request), ending in a host read; returns ``{"failed":
  bool}``;
* ``end_to_end(window_s)``: the end-to-end metrics of the window;
* ``trace_facts()``: the window's counts for the per-layer readers;
* ``release()``: free the program's state;
* ``judge(control=False)``: the numbers compared, worked out again by the
  reference; with ``control`` the reference itself computed in TF32 stands in
  the program's place (the control);
* ``reference_facts()``: what the reference worked out in ``judge`` that a
  per-layer reader needs (the live CG iterations of an LM step).
"""

import contextlib
import gc
from dataclasses import dataclass

import torch

from portbench import compare, inputs, program
from portbench.reference import pinn


@dataclass
class Context:
    config: dict
    params: dict
    seed: int
    device: torch.device


@contextlib.contextmanager
def tf32(enabled):
    """TF32 matrix products on or off inside the block."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.config
        self.params = ctx.params
        self.device = ctx.device
        self.solver = None
        self.draws = None

    def build(self, seed):
        """The program's Solver, seeded from the run's seed, with its
        sampler's draws watched."""
        self.solver = program.solver(self.config, self.device, seed)
        self.draws = program.Draws(self.solver)
        return self.solver

    def reference_facts(self):
        """Facts for the per-layer readers that the reference worked out
        in ``judge`` (none by default)."""
        return {}

    def release(self):
        self.solver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class FirstSteps:
    """The program's first three training steps from ``theta0`` (loaded
    into the solver, or with ``load=False`` its parameters as they stand),
    taken through ``Solver.fit`` with the window's arguments (one step,
    then two with the optimizer and its state carried on) on the points the
    solver's own sampler draws (``draws``, :class:`portbench.program.Draws`),
    read through the program's public surface: each step's loss, the
    optimizer state after the first and the parameters after each step.
    The reference follows the same three steps on the same points."""

    def __init__(self, cell, theta0, fit, first_kwargs, load=True):
        solver, config = cell.solver, cell.config
        self.config = config
        self.theta0 = theta0.detach().clone()
        if load:
            program.load(solver, config, theta0)
        start = len(solver.losses)
        cell.draws.take(2)
        fit(niters=1, **first_kwargs)
        self.state1 = program.optimizer_state(solver)
        self.theta1 = program.flat_params(solver, config)
        fit(niters=2, optimizer=None)
        self.theta3 = program.flat_params(solver, config)
        self.losses = list(solver.losses[start:start + 3])
        self.batches = cell.draws.batches()

    def adam_numbers(self, lr, tf32_control=False):
        """``loss_gap``, ``grad_gap`` (the first gradient as Adam got it:
        its first moment after one step over ``1 - b1``) and ``change_gap``
        (the parameters' change after three steps)."""
        config = self.config
        ref = pinn.adam_steps(config, self.theta0, self.batches, lr)
        if tf32_control:
            with tf32(True):
                losses, grad, theta3 = pinn.adam_steps(config, self.theta0,
                                                       self.batches, lr)
        else:
            losses, theta3 = self.losses, self.theta3
            grad = torch.as_tensor(self.state1["mu"]).to(
                self.theta0.device) / (1 - pinn.ADAM_B1)
        keep = compare.kept_leaves(config, ref[1])
        return {
            "loss_gap": compare.loss_gap(losses, ref[0]),
            "grad_gap": compare.norm_gap(config, grad, ref[1], keep),
            "change_gap": compare.norm_gap(config, theta3 - self.theta0,
                                           ref[2] - self.theta0, keep)}


def first_step_weights(cell, count=1):
    """The weights of the check's run (a stream of their own)."""
    return inputs.weights(cell.config, cell.ctx.seed, inputs.CHECK_WEIGHTS,
                          count, cell.device)
