"""The program's spans (``pydens_tpu_torch.tracing``): nothing recorded and
no profiler range entered while off, the fit's and predict's span trees
while on, the profiler's clock, the ring's bound, the LM and L-BFGS chunk
counters, and on the card the graph tallies and the device records.  The
file imports no JAX, so its card case also runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from one_thread import one_thread  # noqa: F401
from pydens_tpu_torch import D, Solver, tracing

MS = 1_000_000  # ns
FIT_STAGES = ("prepare", "draw", "steps", "read", "commit")


def _poisson(device="cpu", **kw):
    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))
    return Solver(pde, ndims=2, boundary_condition=1, layout="fa fa fa f",
                  activation="Tanh", units=[10, 12, 15, 1], device=device,
                  **kw)


def _grid(n=64):
    return np.random.default_rng(0).random((n, 2)).astype(np.float32)


def _tree(kept):
    """``{root: [its spans]}`` of the kept spans, by trace id."""
    roots = {s.span_id: s for s in kept if s.parent_id is None}
    out = {r: [] for r in roots.values()}
    for s in kept:
        out[roots[s.trace_id]].append(s)
    return out


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *args):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    before = len(tracing.spans(0, 2 ** 63))
    s = _poisson()
    s.fit(niters=6, batch_size=32, chunk_size=3, progress=False)
    s.predict(_grid())
    s.reset(seed=1)
    assert len(tracing.spans(0, 2 ** 63)) == before
    assert entered == []


def test_an_off_span_allocates_nothing():
    def spans(n):
        for _ in range(n):
            with tracing.span("pydens.test") as sp:
                assert sp is None

    spans(10)
    tracemalloc.start()
    try:
        spans(10)
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(10_000)
        end, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # Nothing kept, and no more held at once than one with statement's
    # own frame objects (which are not the span's).
    assert end <= start and peak - start < 1024


def test_on_gives_the_fit_and_predict_span_trees():
    with tracing.recording() as kept:
        s = _poisson()
        s.fit(niters=12, batch_size=50, chunk_size=5, progress=False)
        s.predict(_grid(100))
    tree = _tree(kept)
    assert [r.name for r in tree] == ["pydens.init", "pydens.fit",
                                      "pydens.predict"]
    for root, members in tree.items():
        assert root.trace_id == root.span_id
        assert all(m.trace_id == root.trace_id for m in members)
        assert all(m.parent_id == root.span_id for m in members
                   if m is not root)
        assert all(root.start_ns <= m.start_ns <= m.end_ns <= root.end_ns
                   for m in members)
    fit = next(r for r in tree if r.name == "pydens.fit")
    names = [m.name for m in tree[fit]]
    assert names.count("pydens.fit.prepare") == 1
    assert names.count("pydens.fit.commit") == 1
    for stage in ("draw", "steps", "read"):
        assert names.count(f"pydens.fit.{stage}") == 3
    steps = [m for m in tree[fit] if m.name == "pydens.fit.steps"]
    assert sum(m.attrs["steps"] for m in steps) == 12
    assert [m.attrs["eager"] for m in steps] == [5, 5, 2]
    assert all(m.attrs["replays"] == m.attrs["captures"] == 0
               for m in steps)
    assert [m.attrs["points"] for m in tree[fit]
            if m.name == "pydens.fit.draw"] == [250, 250, 100]
    assert fit.attrs == dict(niters=12, steps=12, batch_size=50,
                             optimizer="Adam", taylor_kernels=1,
                             taylor_plain=0)
    predict = next(r for r in tree if r.name == "pydens.predict")
    assert predict.attrs == {"points": 100}
    assert [m.name for m in tree[predict]][1:] == [
        "pydens.predict.inputs", "pydens.predict.to_device",
        "pydens.predict.apply", "pydens.predict.to_host"]
    # A cached configuration: the second fit's prepare finds its step.
    with tracing.recording() as again:
        s.fit(niters=5, batch_size=50, chunk_size=5, progress=False)
        s.reset()
    assert [m.attrs for m in again if m.name == "pydens.fit.prepare"] == [
        {"cached": True}]
    assert [m.name for m in again if m.parent_id is None] == [
        "pydens.fit", "pydens.reset"]


def test_spans_close_when_a_callback_raises():
    s = _poisson()

    def callback(iteration, losses):
        raise KeyError("stop")

    with tracing.recording() as kept:
        with pytest.raises(KeyError):
            s.fit(niters=10, batch_size=32, chunk_size=5, progress=False,
                  callback=callback)
    assert len(s.losses) == 5
    assert [m.name for m in kept] == [
        "pydens.fit", "pydens.fit.prepare", "pydens.fit.draw",
        "pydens.fit.steps", "pydens.fit.read", "pydens.fit.commit"]
    assert all(0 < m.start_ns <= m.end_ns for m in kept)
    assert kept[0].attrs["steps"] == 5
    assert tracing._local.stack == []
    with tracing.recording() as after:
        s.predict(_grid())
    assert after[0].name == "pydens.predict" and after[0].parent_id is None


def _kineto_ranges(prof):
    """The profiler's host ranges of the program's spans, by name."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("pydens.") and ev.device_type() == \
                torch.autograd.DeviceType.CPU:
            start = ev.start_ns()
            out.setdefault(ev.name(), []).append(
                (start, start + ev.duration_ns()))
    return out


def _assert_on_the_profilers_clock(kept, prof, slack=2 * MS):
    ranges = _kineto_ranges(prof)
    assert sum(map(len, ranges.values())) == len(kept) > 0
    for s in kept:
        lo, hi = min(ranges[s.name], key=lambda r: abs(r[0] - s.start_ns))
        assert s.start_ns - slack <= lo <= hi <= s.end_ns + slack, s
        assert abs(lo - s.start_ns) <= slack and abs(hi - s.end_ns) <= slack


def test_spans_are_on_the_profilers_clock():
    s = _poisson()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = tracing.time.time_ns()
        s.fit(niters=6, batch_size=32, chunk_size=3, progress=False)
        s.predict(_grid())
        t1 = tracing.time.time_ns()
    kept = tracing.spans(t0, t1)
    assert {k.name for k in kept} >= {"pydens.fit", "pydens.fit.steps",
                                      "pydens.predict.to_host"}
    _assert_on_the_profilers_clock(kept, prof)


def test_a_profile_dir_trace_names_the_fits_stages(tmp_path):
    s = _poisson()
    s.fit(niters=4, batch_size=32, chunk_size=2, progress=False,
          profile_dir=str(tmp_path))
    (name,) = os.listdir(tmp_path)
    names = [e.get("name") for e in json.loads(
        (tmp_path / name).read_text())["traceEvents"]]
    for stage in ("pydens.fit",) + tuple(f"pydens.fit.{s}"
                                         for s in FIT_STAGES):
        assert stage in names, stage
    assert names.count("pydens.fit.steps") == 2


def test_the_ring_keeps_the_newest_spans():
    with tracing.recording():
        first = None
        for _ in range(tracing.RING_SIZE + 10):
            with tracing.span("pydens.test") as sp:
                first = first or sp.span_id
    kept = tracing.spans(0, 2 ** 63)
    assert len(kept) == tracing.RING_SIZE
    assert kept[0].span_id == first + 10
    assert kept[-1].span_id == first + tracing.RING_SIZE + 9
    mid = kept[len(kept) // 2]
    assert tracing.spans(mid.start_ns, kept[-1].end_ns)[0] is mid


@pytest.mark.parametrize("optimizer,counter", [("LM", "cg_iters"),
                                               ("LBFGS", "trials")])
def test_a_chunk_counts_the_steps_live_device_counter(optimizer, counter):
    s = _poisson()
    s.fit(niters=3, batch_size=32, progress=False)
    kwargs = dict(cg_iters=6) if optimizer == "LM" else {}
    s.fit(niters=2, batch_size=32, chunk_size=2, resample=False,
          optimizer=optimizer, progress=False, **kwargs)
    (step,) = [st for st in s._step_cache.values() if int(st.live)]
    live = int(step.live)
    with tracing.recording() as kept:
        s.fit(niters=5, batch_size=32, chunk_size=2, resample=False,
              optimizer=None, progress=False)
    chunks = [m for m in kept if m.name == "pydens.fit.steps"]
    assert [m.attrs["steps"] for m in chunks] == [2, 2, 1]
    assert sum(m.attrs[counter] for m in chunks) == int(step.live) - live
    assert all(m.attrs[counter] > 0 for m in chunks)
    # No draw a chunk with resample=False: the fixed batch is prepare's.
    assert "pydens.fit.draw" not in {m.name for m in kept}


def _nls(device="cpu", **kw):
    """The periodic Schrodinger system of examples/15 at [16, 16, 2]: its
    Taylor closure (u_x, u_t, u_xx) from the embedding's state."""
    def nls(f, x, t):
        hr, hi = f[:, 0:1], f[:, 1:2]
        mag2 = hr * hr + hi * hi
        return (D(hr, t) + 0.5 * D(D(hi, x), x) + mag2 * hi,
                -D(hi, t) + 0.5 * D(D(hr, x), x) + mag2 * hr)
    return Solver(nls, ndims=2, domain=[(-5.0, 5.0), (0.0, np.pi / 2)],
                  periodic=(0,), periodic_ic_decay=False,
                  initial_condition=lambda x: torch.stack(
                      [2.0 / torch.cosh(x), torch.zeros_like(x)], -1),
                  layout="fa fa f", activation="Tanh", units=[16, 16, 2],
                  device=device, **kw)


def _plate():
    """An order-four equation: its closure is off the kernels."""
    def pde(f, x, y):
        return D(D(D(D(f, x), x), x), x) + D(D(f, y), y) - 1.0
    return Solver(pde, ndims=2, boundary_condition=0, layout="fa f",
                  activation="Tanh", units=[8, 1], device="cpu")


@pytest.mark.parametrize("name,make,fit,routes", [
    ("raw", _poisson, {}, (1, 0)),
    ("periodic", _nls, {}, (1, 0)),
    ("periodic_lm", _nls, dict(optimizer="LM", cg_iters=3,
                               resample=False), (2, 0)),
    ("order4", _plate, {}, (0, 1)),
    ("nested", _poisson, dict(fast_taps=False), (0, 0)),
])
def test_the_fit_span_names_the_steps_taylor_routes(name, make, fit, routes):
    # taylor_kernels / taylor_plain on the pydens.fit span: the step's
    # Taylor traversals on the fused kernels' route (from the raw
    # coordinates or an embedding's state) and on the plain traversal; none
    # with nested gradients.  A cached step reports the same again.
    s = make()
    for _ in range(2):
        with tracing.recording() as kept:
            s.fit(niters=2, batch_size=32, progress=False, **fit)
        root, = [m for m in kept if m.name == "pydens.fit"]
        assert (root.attrs["taylor_kernels"],
                root.attrs["taylor_plain"]) == routes


@pytest.mark.gpu
def test_on_the_card_graph_tallies_and_device_records():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")
    from portbench import trace
    s = _poisson(device="cuda")
    runs, names = [], []
    for _ in range(2):
        with tracing.recording() as kept:
            s.fit(niters=20, batch_size=100, chunk_size=10, progress=False)
        runs.append([m.attrs for m in kept if m.name == "pydens.fit.steps"])
        names.append({m.name for m in kept})
    # First fit: the warm-up step, one capture, replays; the second fit
    # replays the cached graph only.
    assert [(a["eager"], a["captures"], a["replays"]) for a in runs[0]] \
        == [(1, 1, 9), (0, 0, 10)]
    assert [(a["eager"], a["captures"], a["replays"]) for a in runs[1]] \
        == [(0, 0, 10), (0, 0, 10)]
    assert {"pydens.fit.warmup", "pydens.fit.capture"} <= names[0]
    assert not {"pydens.fit.warmup", "pydens.fit.capture"} & names[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = tracing.time.time_ns()
        s.fit(niters=20, batch_size=100, chunk_size=10, progress=False)
        s.predict(_grid(10_000))
        torch.cuda.synchronize()
        t1 = tracing.time.time_ns()
    device, host = trace._events(prof)
    assert device and not [n for n, _, _ in device
                           if n.startswith("pydens.")]
    assert any(n == "pydens.fit.steps" for n, _, _ in host)
    _assert_on_the_profilers_clock(tracing.spans(t0, t1), prof)
