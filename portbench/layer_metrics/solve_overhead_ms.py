"""A solve's time outside its fit's steps: each ``portbench.solve`` span
less the device's span of the step work inside its ``portbench.fit``
span (first record's start to last record's end), averaged over the
traced solves.  It holds ``Solver.reset``, the weights' load, the fit's
set-up and chunk reads and ``predict``, as the traced host runs them: the
profiler's cost on each of their host operations is in it."""


def read(r):
    solves = [s for s in r.spans if s[0] == "portbench.solve"]
    fits = [s for s in r.spans if s[0] == "portbench.fit"]
    if not solves or len(fits) != len(solves):
        return None
    total = 0
    for solve, fit in zip(sorted(solves, key=lambda s: s[1]),
                          sorted(fits, key=lambda s: s[1])):
        ops = r.within(fit)
        device = (max(e for _, _, e in ops) - min(s for _, s, _ in ops)
                  if ops else 0)
        total += (solve[2] - solve[1]) - device
    return total / len(solves) / 1e6
