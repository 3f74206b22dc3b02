"""The cell ``nls-raissi.adam-nf20000`` (Raissi et al.'s Schrodinger PINN on
the fused Taylor kernels from the periodic embedding's state), on the CPU
at an override size: it resolves by name, its check passes a sound run and
fails one with a fault planted (each of its traffic kind's, and an input
state whose (x, x) taps are zeroed), its traced run reports its metrics,
and ``portbench/work_embedded.py`` agrees with hand counts."""

import time

import pytest
import torch

from portbench import faults, harness, work, work_embedded
from portbench.reference import periodic_pinn

CELL = "nls-raissi.adam-nf20000"
SMALL = dict(batch_size=64, chunk_size=4)
CFG = harness.config("nls-raissi")


def run(traced=False, seed=2 ** 31 + 91):
    return harness.run_cell(CELL, seed, 0.3, traced, torch.device("cpu"),
                            time.perf_counter(), overrides=SMALL)


def test_the_cell_resolves_by_name():
    bench = harness.manifest()
    listed, = [w for w in bench["workloads"] if w["name"] == CELL]
    wl = harness.workload(CELL)
    assert (wl["config"], wl["traffic"]) == (listed["config"],
                                             listed["traffic"])
    assert CFG["reference"] == "periodic_pinn" and CFG["reduced"] == []
    module = harness.traffic(wl["traffic"])
    assert module.reference(CFG) is periodic_pinn
    names = {m["name"] for m in harness.metrics_of(bench, CELL,
                                                   "per_layer")}
    assert names == {"roofline.taylor_fwd.nls", "roofline.taylor_bwd.nls",
                     "mfu.fit.nls", "device_idle_share.fit.nls",
                     "step_device_ops.nls", "taylor_plain_share.nls"}
    for name in names:
        assert callable(harness.reader(name).read)
    assert harness.reader("device_idle_share.fit.nls").__name__.endswith(
        "layer_metrics.device_idle_share")
    assert {m["name"] for m in harness.metrics_of(
        bench, CELL, "end_to_end")} == {"setup_s", "fit_points_per_s"}


def test_the_reference_loads_the_programs_published_shape():
    # [2, 100, 100, 100, 100, 2] with x embedded as (sin, cos): the first
    # layer 3 x 100, 30,902 network parameters and log_scale.
    assert periodic_pinn.dense_shapes(CFG) == [
        (3, 100), (100, 100), (100, 100), (100, 100), (100, 2)]
    assert periodic_pinn.init_bounds(CFG, "cpu").numel() == 30_903


def test_a_sound_run_is_correct(one_thread):
    result = run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["fit_points_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", harness.traffic("adam_fixed").FAULTS)
def test_each_fault_makes_the_run_not_correct(fault, one_thread):
    with faults.planted(fault):
        result = run()
    assert not result["correct"], (fault, result["checks"])


def test_an_input_state_without_its_xx_taps_is_not_correct(monkeypatch,
                                                            one_thread):
    # The kernels' likeliest error of this path: the embedding's state
    # handed over without its second-order (x, x) taps (the periodic
    # column's -w^2 sin, -w^2 cos), as if the state were seeded as the raw
    # coordinates' S = 0.
    from pydens_tpu_torch.ops import fused_taylor
    taps = fused_taylor.fused_taylor_taps
    zeroed = []

    def patched(packed, x, plan):
        if plan.input_state:
            x = x.clone()
            x[:, 1 + len(plan.firsts):] = 0
            zeroed.append(plan.pairs)
        return taps(packed, x, plan)
    monkeypatch.setattr(fused_taylor, "fused_taylor_taps", patched)
    result = run()
    assert zeroed and zeroed[0] == [(0, 0)]
    assert not result["correct"], result["checks"]


def test_a_traced_run_reports_the_cells_metrics(one_thread):
    """No device operation runs here, so the kernel and op readers find
    nothing; the route's share reads 0: every traversal on the kernels'
    route (their plain twin on the CPU)."""
    result = run(traced=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["taylor_plain_share.nls"]["value"] == 0
    assert {"mfu.fit.nls", "device_idle_share.fit.nls"} <= set(metrics)


def test_the_plain_route_reads_a_whole_share(monkeypatch, one_thread):
    # A program that keeps the embedded chain on the plain traversal (as
    # the parent of the change did) reads 100.
    from pydens_tpu_torch.models.base import ConvBlockModel
    monkeypatch.setattr(ConvBlockModel, "_fused_taylor_plan",
                        lambda self, closure: None)
    result = run(traced=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["taylor_plain_share.nls"]["value"] == 100



@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_the_tf32_control_fails_a_limit(seed, cuda_device):
    # The reference in TF32 in the program's place, at the cell's size.
    from portbench.calibrate import reading
    from portbench.cell import Context
    wl = harness.workload(CELL)
    module = harness.traffic(wl["traffic"])
    ctx = Context(CFG, dict(wl["params"]), seed, cuda_device)
    numbers = reading(module, ctx, 0.0, control=True)
    assert any(v > wl["limits"][k] for k, v in numbers.items()), numbers

def test_work_embedded_counts_by_hand():
    # Products: 3*100 + 3 * 100*100 + 100*2 = 30,500; parameters 400 +
    # 3 * 10,100 + 202 = 30,902; four streams: u, u_x, u_t, u_xx.
    n, p, s = 20000, 30902, 4
    assert work_embedded.embed_width(CFG) == 3
    assert work_embedded.products(CFG) == 30500
    assert work_embedded.net_params(CFG) == p and work.streams(CFG) == s
    fwd = 4 * (n * s * 3 + p + n * s * 2)
    assert work_embedded.taylor_forward(CFG, n) == (n * s * 30500, fwd)
    assert work_embedded.taylor_backward(CFG, n) == (2 * n * s * 30500,
                                                     fwd + 4 * p)
    assert work_embedded.adam_step_flops(CFG, n) == 2 * 3 * n * s * 30500
    # 2.44 G FMAs: 73 us at the float32 peak, the forward's bound.
    assert work.bound_s(*work_embedded.taylor_forward(CFG, n)) == \
        pytest.approx(2 * n * s * 30500 / 67e12)
    wider = dict(CFG, periodic={"0": 2})
    assert work_embedded.embed_width(wider) == 5


def test_the_reference_loads_nothing_of_the_program():
    import json
    import subprocess
    import sys
    script = f"""
import sys, json, torch
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import harness
from portbench.reference import periodic_pinn as ref
cfg = harness.config('nls-raissi')
theta = torch.zeros(ref.init_bounds(cfg, 'cpu').numel())
ref.adam_steps(cfg, theta, [torch.rand(8, 2)], 1e-3)
ref.predict(cfg, theta, torch.rand(8, 2))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}}
                        & {{'jax', 'jaxlib', 'flax', 'pydens_tpu',
                           'pydens_tpu_torch'}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
