"""Host microseconds a fit step takes to enqueue: the program's
``pydens.fit.steps`` spans (a chunk's graph replays, or its eager steps,
on the host) over the steps they ran (their ``steps`` counter)."""

from portbench.program_spans import spans


def read(r):
    chunks = spans(r, "pydens.fit.steps")
    steps = sum(s.attrs.get("steps", 0) for s in chunks)
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in chunks) / steps / 1e3
