"""Live conjugate-gradient iterations a Levenberg-Marquardt step, as the
program counts them on the device: the ``cg_iters`` counter of its
``pydens.fit.steps`` spans over their ``steps``."""

from portbench.program_spans import spans


def read(r):
    chunks = [s for s in spans(r, "pydens.fit.steps")
              if "cg_iters" in s.attrs]
    steps = sum(s.attrs["steps"] for s in chunks)
    if not steps:
        return None
    return sum(s.attrs["cg_iters"] for s in chunks) / steps
