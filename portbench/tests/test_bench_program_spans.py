"""The readers of the program's own spans (``portbench/program_spans.py``)
on made-up records: spans of the program's tracer placed in a window, with
made-up device operations, and nothing read where the window holds no
program span or the program has no tracer."""

import itertools
import sys
import time

import pytest

from portbench import harness, program_spans, trace
from pydens_tpu_torch import tracing

WIDE = harness.config("poisson2d-wide64")
MS = 1_000_000   # ns
NEW = ("fit_launch_us.solve", "solve_host_ms", "predict_to_device_ms",
       "predict_to_host_ms", "predict_idle_in_program_ms",
       "lm_cg_live_per_step")
# Each test's spans lie an hour back, a second from any other test's, so no
# window of a real run holds them.
_slot = itertools.count()


@pytest.fixture
def base():
    return time.time_ns() - 3600 * 10 ** 9 + next(_slot) * 10 ** 9


def put(base, name, start_ms, end_ms, **attrs):
    """A span of the program's tracer, moved to ``[start_ms, end_ms]`` after
    ``base``."""
    with tracing.recording():
        with tracing.span(name) as sp:
            sp.attrs.update(attrs)
    sp.start_ns = base + int(start_ms * MS)
    sp.end_ns = base + int(end_ms * MS)
    return sp


def reading(base, ops=(), facts=None):
    ops = [(n, base + int(s * MS), base + int(e * MS)) for n, s, e in ops]
    return trace.Reading(WIDE, {}, (base, base + 100 * MS), ops, [],
                         facts or {})


def read(metric, r):
    return harness.reader(metric).read(r)


def test_the_new_metrics_are_in_the_manifest_with_their_readers():
    listed = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in NEW:
        assert listed[name]["source"] in ("program_span", "program_counter")
        assert callable(harness.reader(name).read)


def test_launch_time_a_step(base):
    put(base, "pydens.fit.steps", 1, 4, steps=500)
    put(base, "pydens.fit.steps", 10, 12, steps=500)
    put(base, "pydens.fit.read", 12, 30)
    put(base, "pydens.fit.steps", 99, 101, steps=500)   # past the window
    assert read("fit_launch_us.solve", reading(base)) == pytest.approx(5.0)


def test_a_solves_host_stages(base):
    for k in (0, 50):
        put(base, "pydens.reset", k + 0, k + 1)
        put(base, "pydens.fit", k + 1, k + 40)
        put(base, "pydens.fit.prepare", k + 1, k + 1.5)
        put(base, "pydens.fit.draw", k + 1.5, k + 1.7)
        put(base, "pydens.fit.steps", k + 1.7, k + 30, steps=500)
        put(base, "pydens.fit.read", k + 30, k + 39.7)
        put(base, "pydens.fit.commit", k + 39.7, k + 40)
        put(base, "pydens.predict", k + 40, k + 42)
        put(base, "pydens.predict.to_host", k + 41, k + 42)
    assert read("solve_host_ms", reading(base)) == pytest.approx(4.0)


def test_a_requests_copies(base):
    for k, (to_dev, to_host) in enumerate(((1.0, 0.5), (1.5, 0.7))):
        t = 10 * k
        put(base, "pydens.predict", t, t + 4)
        put(base, "pydens.predict.inputs", t, t + 0.2)
        put(base, "pydens.predict.to_device", t + 0.2, t + 0.2 + to_dev)
        put(base, "pydens.predict.apply", t + 2, t + 2.5)
        put(base, "pydens.predict.to_host", t + 3, t + 3 + to_host)
    r = reading(base)
    assert read("predict_to_device_ms", r) == pytest.approx(1.25)
    assert read("predict_to_host_ms", r) == pytest.approx(0.6)


def test_device_idle_inside_the_programs_predict(base):
    put(base, "pydens.predict", 10, 20)
    put(base, "pydens.predict", 50, 54)
    ops = [("Memcpy HtoD", 12, 15), ("mlp_fwd_kernel", 14, 17),
           ("Memcpy DtoH", 30, 40)]
    # 10 ms less 5 busy, then 4 ms with nothing on the device.
    assert read("predict_idle_in_program_ms", reading(base, ops)) == \
        pytest.approx(4.5)
    assert read("predict_idle_in_program_ms", reading(base, [
        ("k", 0, 100)])) == 0


def test_live_cg_iterations_a_step(base):
    put(base, "pydens.fit.steps", 1, 20, steps=10, cg_iters=500)
    put(base, "pydens.fit.steps", 30, 50, steps=10, cg_iters=480)
    put(base, "pydens.fit.steps", 60, 70, steps=500)    # an Adam chunk
    assert read("lm_cg_live_per_step", reading(base)) == pytest.approx(49.0)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_without_program_spans(metric, base):
    put(base, "pydens.init", 150, 160)      # outside the window
    assert read(metric, reading(base, [("k", 0, 10)], {"steps": 10,
                                                         "requests": 2})) \
        is None


def test_a_program_without_the_tracer_has_no_spans(base, monkeypatch):
    put(base, "pydens.predict", 10, 20)
    r = reading(base)
    assert program_spans.spans(r)
    monkeypatch.setitem(sys.modules, "pydens_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["pydens_tpu_torch"], "tracing")
    assert program_spans.spans(r) == []
    assert read("predict_idle_in_program_ms", r) is None
