"""Spans of the program's stages, on the profiler's clock.

A span marks one stage of a call (``pydens.fit.steps``, say): its name,
its start and end in unix-epoch nanoseconds (``time.time_ns``, the clock
of ``torch.profiler``'s records, so a span lines up with the device's
operations of the same trace), its own id, the id of the span open around
it on the same thread (``parent_id``), the ``trace_id`` that every span
under one root call shares, and ``attrs``, the counters taken at that
boundary.  Closed spans are kept in memory, the newest :data:`RING_SIZE`
of them.

Recording is on while :func:`recording` is open or while a
``torch.profiler`` records; while a profiler records, each span is also a
``record_function`` range of its name, so the profiler's own trace names
the program's stages.  Off, :func:`span` checks the two and returns a
shared no-op: it allocates nothing and enters no ``record_function``.

    with tracing.recording() as kept:
        solver.fit(niters=1000, batch_size=1024)
    for s in kept:
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)

The spans the program opens (each ``pydens.*``; the roots are
``pydens.init``, ``pydens.fit``, ``pydens.reset``, ``pydens.predict`` and
``pydens.kernels.build``) are listed in the README.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

__all__ = ["Span", "span", "recording", "spans", "RING_SIZE"]

RING_SIZE = 65_536

_profiler_enabled = torch.autograd._profiler_enabled
_ring = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()
_recording = 0      # open recording() blocks, over every thread
_count_lock = threading.Lock()


class Span:
    """One recorded stage; a context manager that :func:`span` returns
    while recording is on."""

    __slots__ = ("name", "start_ns", "end_ns", "span_id", "parent_id",
                 "trace_id", "attrs", "_range")

    def __init__(self, name):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.span_id = next(_ids)
        self.attrs = {}
        self._range = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (parent.trace_id if parent is not None
                         else self.span_id)
        stack.append(self)
        # Stamped outside the profiler's range, so the span holds it.
        self.start_ns = time.time_ns()
        if _profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _local.stack.remove(self)
        _ring.append(self)
        return False


class _Off:
    """The span of a stage while recording is off: enters as None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A span of the stage ``name``, to open with ``with``: it enters as
    its :class:`Span` record while recording is on (set counters on its
    ``attrs``), as None while off."""
    if _recording or _profiler_enabled():
        return Span(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record every span while the block is open (the process's, every
    thread's).  Yields a list that, when the block closes, holds the kept
    spans that started and ended inside it, oldest first."""
    global _recording
    kept = []
    with _count_lock:
        _recording += 1
    lo = time.time_ns()
    try:
        yield kept
    finally:
        hi = time.time_ns()
        with _count_lock:
            _recording -= 1
        kept.extend(spans(lo, hi))


def spans(lo_ns, hi_ns):
    """The kept spans that lie within ``[lo_ns, hi_ns]`` (unix-epoch ns),
    by their start."""
    return sorted((s for s in list(_ring)
                   if s.start_ns >= lo_ns and s.end_ns <= hi_ns),
                  key=lambda s: s.start_ns)
