"""Faults planted in the program's timed path, to show that the check
catches them: each a patch of functions of ``pydens_tpu_torch``, undone on
leaving the block.

* ``state_unchanged``: a training step that leaves the parameters and the
  optimizer state as they were (its loss is still recorded);
* ``half_batch``: a step that trains on the first half of its batch, the
  mean taken over those points;
* ``answer_altered``: ``predict``'s first answer moved by 0.01 where the
  model produces it;
* ``tangent_off``: the tangent ``J v`` of the Taylor traversal (the tangent
  kernel's output on the card) off by ``TANGENT_ERROR``, relative;
* ``reset_keeps_state``: ``Solver.reset`` that leaves the last fit's
  optimizer state (Adam's moments and count) to the next fit's fresh
  optimizer.
"""

import contextlib

TANGENT_ERROR = 1e-3


def _patches(name):
    """``[(owner, attribute, replacement), ...]`` of fault ``name``."""
    from pydens_tpu_torch import solver
    from pydens_tpu_torch.models import base
    from pydens_tpu_torch.ops import fused_taylor
    from pydens_tpu_torch.utils import optimizers
    if name == "state_unchanged":
        step = solver._FitStep.step

        def patched(self, *args, **kwargs):
            buffers = [self.theta, *self.state.values()]
            saved = [b.detach().clone() for b in buffers]
            out = step(self, *args, **kwargs)
            for b, s in zip(buffers, saved):
                b.data.copy_(s)
            return out
        return [(solver._FitStep, "step", patched)]
    if name == "half_batch":
        row = solver._FitStep._points_row

        def patched(self):
            pts = row(self)
            return pts[:pts.shape[0] // 2]
        return [(solver._FitStep, "_points_row", patched)]
    if name == "answer_altered":
        apply = base.Model.predict_apply

        def patched(self, params, xs):
            out = apply(self, params, xs).clone()
            out.view(-1)[0] += 0.01
            return out
        return [(base.Model, "predict_apply", patched)]
    if name == "tangent_off":
        jvp = fused_taylor.fused_taylor_jvp

        def patched(*args, **kwargs):
            out, tangent = jvp(*args, **kwargs)
            return out, tangent * (1 + TANGENT_ERROR)
        patched.launches = jvp.launches   # the wrapper counts its calls
        return [(fused_taylor, "fused_taylor_jvp", patched)]
    if name == "reset_keeps_state":
        reset, init = solver.Solver.reset, optimizers._FlatOptimizer.init
        kept = []

        def patched_reset(self, *args, **kwargs):
            if self._opt_state is not None:
                kept[:] = [{k: v.clone() for k, v in
                            self._opt_state.items()}]
            return reset(self, *args, **kwargs)

        def patched_init(self, theta):
            return kept.pop() if kept else init(self, theta)
        return [(solver.Solver, "reset", patched_reset),
                (optimizers._FlatOptimizer, "init", patched_init)]
    raise ValueError(f"no fault {name!r}")


@contextlib.contextmanager
def planted(name):
    patches = _patches(name)
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, replacement in patches:
        setattr(owner, attr, replacement)
    try:
        yield
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
