"""Device operations a fit step: every device record of the traced window,
over the steps the program's ``pydens.fit.steps`` spans count (their
``steps`` attribute)."""

from portbench.program_spans import spans


def read(r):
    steps = sum(s.attrs.get("steps", 0)
                for s in spans(r, "pydens.fit.steps"))
    if not steps or not r.device_ops:
        return None
    return len(r.device_ops) / steps
