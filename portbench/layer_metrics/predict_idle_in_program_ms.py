"""Device idle milliseconds a request while the host is inside the
program's predict: the window less the union of the device's operations,
within the program's ``pydens.predict`` spans (which do not overlap), over
those spans."""

from portbench import trace
from portbench.program_spans import spans


def read(r):
    requests = spans(r, "pydens.predict")
    if not requests:
        return None
    busy = trace.merged(r.device_ops)
    idle = 0
    for s in requests:
        lo, hi = max(s.start_ns, r.window[0]), min(s.end_ns, r.window[1])
        covered = sum(max(0, min(e, hi) - max(b, lo)) for b, e in busy)
        idle += max(hi - lo, 0) - covered
    return idle / len(requests) / 1e6
