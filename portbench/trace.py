"""The traced run's window: ``torch.profiler`` over a fixed number of the
cell's units, reduced to device busy time, kernel time by name, the
benchmark's own spans and the host's activity in the device's idle gaps.

The profiler takes the same units once before the measured window and
drops them (its warm-up): without it the first records of a window were
lost on the card (the 64-wide fit: 18 of 26,626 records, one of them a
forward kernel).  The profiler also lengthens the host's side of each
unit (a README solve's graph launches most: 0.82-0.93 s traced against
0.43 s), so the same units are also timed untraced, by the host clock
over at least ``UNTRACED_S``, and the idle share and the MFU are read
against that.
"""

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
UNIT = "portbench.unit"
SPAN_PREFIX = "portbench."
UNTRACED_S = 1.0        # least host-clock span of the untraced timing
LABELLED_GAPS = 200     # the longest gaps whose host activity is named
TOP = 10


@dataclass
class Reading:
    """What the per-layer readers read: the cell's configuration and
    parameters, the window (ns on the profiler's clock), the device's
    operations ``(name, start, end)``, the benchmark's spans ``(name,
    start, end)`` and the cell's own facts about the window (steps,
    points, requests, live CG iterations, ...)."""
    config: dict
    params: dict
    window: tuple
    device_ops: list
    spans: list
    facts: dict = field(default_factory=dict)
    unit_s: float = 0.0     # one unit's seconds, untraced

    @property
    def units(self):
        return self.facts.get("units", 0)

    @property
    def untraced_s(self):
        """The traced units' seconds without the profiler."""
        return self.units * self.unit_s

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self):
        return sum(e - s for s, e in merged(self.device_ops)) / 1e9

    def kernel_times(self, needle):
        """``(launches, seconds)`` of the device operations whose name holds
        ``needle``."""
        hits = [e - s for name, s, e in self.device_ops if needle in name]
        return len(hits), sum(hits) / 1e9

    def within(self, span):
        _, lo, hi = span
        return [op for op in self.device_ops if op[1] >= lo and op[2] <= hi]


def merged(ops):
    """The union of the operations' intervals, sorted."""
    out = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(prof):
    """``(device, host)`` lists of ``(name, start_ns, end_ns)``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        row = (ev.name(), start, start + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            # Annotations (the benchmark's spans, the schedule's steps)
            # also show as device records spanning them: not device work.
            if not (ev.is_user_annotation() or row[0].startswith(
                    ("ProfilerStep", SPAN_PREFIX))):
                device.append(row)
        else:
            host.append(row)
    return device, host


def profile_units(cell, units):
    """Run ``units`` of the cell twice under the profiler, the first time as
    its dropped warm-up.  Returns ``(device ops, host events, window)``."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    cuda = cell.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for label in ("portbench.warmup", WINDOW):
            cell.window_begin()
            with record_function(label):
                for _ in range(units):
                    with record_function(UNIT):
                        cell.unit()
                if cuda:
                    torch.cuda.synchronize(cell.device)
            prof.step()
    device, host = _events(prof)
    marks = [h for h in host if h[0] == WINDOW]
    if len(marks) != 1:
        raise RuntimeError(f"the profiler kept {len(marks)} window marks")
    _, lo, hi = marks[0]
    device = [op for op in device if op[2] > lo and op[1] < hi]
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device]
    host = [h for h in host if h[2] > lo and h[1] < hi]
    return device, host, (lo, hi)


def breakdown(device, host, window):
    """The device operations that took most time, and the host's activity
    in the longest idle gaps (the innermost host event that spans a gap's
    middle; the gap's seconds summed by that name)."""
    by_name = defaultdict(int)
    for name, s, e in device:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = merged(device)
    edges = [window[0]] + [x for s, e in busy for x in (s, e)] + [window[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    host = [h for h in host if h[0] != WINDOW
            and not h[0].startswith("ProfilerStep")]
    idle = defaultdict(int)
    for length, s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) // 2
        spans = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(spans, key=lambda h: h[2] - h[1])[0] if spans
                else "host outside any recorded op")
        idle[name] += length
    idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def untraced_unit_s(cell, units):
    """Seconds a unit takes without the profiler: whole passes of ``units``
    units, by the host clock, until ``UNTRACED_S`` have passed."""
    cuda = cell.device.type == "cuda"
    cell.window_begin()
    done, t0 = 0, time.perf_counter()
    while True:
        for _ in range(units):
            cell.unit()
        done += units
        if cuda:
            torch.cuda.synchronize(cell.device)
        seconds = time.perf_counter() - t0
        if seconds >= UNTRACED_S:
            return seconds / done


def reading(cell, units):
    """Time the cell's units untraced, then profile its window, and return
    ``(Reading, breakdown)``.  The untraced timing comes first: after the
    profiler had stopped, the LM cell's next fit call took 7.1 s against
    1.67 s in the traced window (on an H100; the cause is not known)."""
    unit_s = untraced_unit_s(cell, units)
    device, host, window = profile_units(cell, units)
    spans = [h for h in host if h[0].startswith(SPAN_PREFIX)
             and h[0] != WINDOW]
    facts = dict(cell.trace_facts(), units=units)
    read = Reading(cell.config, cell.params, window, device, spans, facts,
                   unit_s)
    return read, breakdown(device, host, window)
