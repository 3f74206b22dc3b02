"""The program's own spans in a traced window: the spans that
``pydens_tpu_torch.tracing`` kept between the window's ends (ns on the
profiler's clock, which the tracer shares).  The program records them while
the profiler records, so the traced window has them with no switch of the
benchmark's.  A program without the tracer has none, and each reader of
them then finds nothing to read."""


def spans(r, *names):
    """The program's spans within ``r.window`` (a ``trace.Reading``), by
    their start; those named ``names`` only, where given."""
    try:
        from pydens_tpu_torch import tracing
    except ImportError:
        return []
    return [s for s in tracing.spans(*r.window)
            if not names or s.name in names]


def ms_a_request(r, name):
    """Host milliseconds a request (a ``pydens.predict`` span) spends in
    the spans named ``name``; None without requests."""
    requests = spans(r, "pydens.predict")
    if not requests:
        return None
    inside = sum(s.end_ns - s.start_ns for s in spans(r, name))
    return inside / len(requests) / 1e6
