"""The traced window's arithmetic on made-up records: busy time, kernel
shares, spans, the breakdown, and readers that find nothing."""

import pytest

from portbench import harness, trace, work

WIDE = harness.config("poisson2d-wide64")
MS = 1_000_000   # ns


def reading(ops, spans=(), facts=None, unit_s=0.0):
    return trace.Reading(WIDE, {}, (0, 100 * MS), list(ops), list(spans),
                         facts or {}, unit_s)


def test_busy_time_is_the_union_of_records():
    r = reading([("a", 0, 10 * MS), ("b", 5 * MS, 20 * MS),
                 ("c", 50 * MS, 60 * MS)])
    assert r.busy_s == pytest.approx(0.030)
    assert r.window_s == pytest.approx(0.1)


@pytest.mark.parametrize("kind", ["fit", "fit.lm", "predict"])
def test_idle_share_is_read_against_the_untraced_units(kind):
    """30 ms busy in two units that take 40 ms each untraced: 62.5% idle,
    whatever the (profiler-lengthened) traced window."""
    r = reading([("a", 0, 10 * MS), ("b", 5 * MS, 20 * MS),
                 ("c", 50 * MS, 60 * MS)], facts={"units": 2},
                unit_s=0.040)
    assert harness.reader(f"device_idle_share.{kind}").read(r) == \
        pytest.approx(62.5)
    assert harness.reader(f"device_idle_share.{kind}").read(
        reading([], facts={})) is None


def test_roofline_and_mfu_read_kernel_time_by_name():
    n = 65536
    fwd_s = work.bound_s(*work.taylor_forward(WIDE, n))
    ops = [("void taylor_fwd_kernel<1>", 0, int(4 * fwd_s * 1e9)),
           ("taylor_bwd_kernel", 0, 2 * MS), ("reduce_partials_kernel", 0,
                                                MS)]
    r = reading(ops, facts={"points": n, "steps": 10, "units": 2,
                            "step_kind": "first_order"}, unit_s=0.05)
    assert harness.reader("roofline.taylor_fwd").read(r) == \
        pytest.approx(25.0, rel=1e-6)
    bwd = work.bound_s(*work.taylor_backward(WIDE, n))
    assert harness.reader("roofline.taylor_bwd").read(r) == \
        pytest.approx(100 * bwd / 3e-3)
    assert harness.reader("mfu.fit").read(r) == pytest.approx(
        100 * 10 * work.adam_step_flops(WIDE, n) / 0.1 / 67e12)
    assert harness.reader("roofline.taylor_jvp").read(r) is None
    assert harness.reader("roofline.mlp_fwd").read(r) is None


def test_solve_spans_and_ops_per_step():
    ops = [("k", 2 * MS + i * MS, 2 * MS + i * MS + 500_000)
           for i in range(8)]
    spans = [("portbench.solve", MS, 20 * MS), ("portbench.fit", 2 * MS,
                                                 11 * MS)]
    r = reading(ops, spans, {"steps": 4})
    assert harness.reader("step_device_ops.solve").read(r) == 2.0
    # 19 ms of solve less 7.5 ms from the first record's start to the last's
    # end inside the fit.
    assert harness.reader("solve_overhead_ms").read(r) == pytest.approx(11.5)


def test_breakdown_names_ops_and_the_hosts_idle_activity():
    ops = [("k1", 10 * MS, 40 * MS), ("k2", 60 * MS, 70 * MS)]
    host = [("aten::item", 40 * MS, 60 * MS), ("outer", 0, 100 * MS)]
    out = trace.breakdown(ops, host, (0, 100 * MS))
    assert out["device_ops"] == [["k1", 0.03], ["k2", 0.01]]
    assert out["idle_gaps"] == [["outer", 0.04], ["aten::item", 0.02]]


def test_readers_without_records_return_nothing():
    r = reading([], facts={})
    for m in harness.manifest()["per_layer"]:
        assert harness.reader(m["name"]).read(r) is None, m["name"]


def test_lm_mfu_counts_the_reference_cg_iterations():
    n = 65536
    facts = {"points": n, "steps": 10, "units": 1, "step_kind": "lm"}
    r = reading([], facts=dict(facts), unit_s=1.5)
    assert harness.reader("mfu.fit").read(r) is None
    r = reading([], facts=dict(facts, live_cg_per_step=37.0), unit_s=1.5)
    assert harness.reader("mfu.fit").read(r) == pytest.approx(
        100 * 10 * work.lm_step_flops(WIDE, n, 37.0) / 1.5 / 67e12)
