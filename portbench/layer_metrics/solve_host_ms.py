"""A solve's host milliseconds outside its steps and their host read: the
program's ``pydens.reset``, ``pydens.fit.prepare``, ``pydens.fit.draw``,
``pydens.fit.commit`` and ``pydens.predict`` spans, over the solves (one
``pydens.reset`` each)."""

from portbench.program_spans import spans

STAGES = ("pydens.reset", "pydens.fit.prepare", "pydens.fit.draw",
          "pydens.fit.commit", "pydens.predict")


def read(r):
    kept = spans(r, *STAGES)
    solves = sum(s.name == "pydens.reset" for s in kept)
    if not solves:
        return None
    return sum(s.end_ns - s.start_ns for s in kept) / solves / 1e6
