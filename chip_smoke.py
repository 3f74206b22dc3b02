"""Smoke run of pydens_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card and its power limit; f32 matmuls and
   convolutions without TF32;
2. build: compiles the CUDA kernels of pydens_tpu_torch/csrc (timed);
3. kernels vs plain: every kernel against its plain PyTorch version on the
   card, at the README workload's shapes and at large ones, with timings;
4. the README 2D Poisson fit (1500 Adam steps, batch 100) and predict on a
   100 x 100 grid through the public Solver, with the launch counters
   showing that every step ran the fused Taylor kernels and predict the
   fused MLP kernel; then the same fit with the kernels routed to their
   plain versions, for the comparison of iterations/s.

Prints one JSON line of per-kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]
README = dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
              activation="Tanh", units=[10, 12, 15, 1])


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps):
    """Mean device time of one call of ``fn`` over ``reps`` calls (after a
    warm-up), from CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return float((a - b).abs().max())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")
    log("precision: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    return name, smi


def phase_build():
    from pydens_tpu_torch.ops._build import load_library
    t0 = time.perf_counter()
    lib = load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({lib.path})")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def _taylor_case(features, n, seed):
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_taylor as ft
    dev = torch.device("cuda")
    net = make_layout_network("fa fa fa f", features, "Tanh", in_dim=2,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    plan = ft.TaylorPlan(net.tokens, net.activations, POISSON_CLOSURE,
                         net.layer_shapes, 2)
    with torch.no_grad():
        packed = ft.pack_weights(net.params(), net.layer_names)
    x = torch.rand((n, 2), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    return plan, packed, x


def check_taylor(features, n, seed=0, reps=0):
    """Forward and backward kernels against the plain autograd path."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, packed, x = _taylor_case(features, n, seed)
    out = ft.fused_taylor_forward(packed, x, plan)
    ref = ft.fused_taylor_forward_plain(packed, x, plan)
    sync()
    torch.testing.assert_close(out, ref, **VALUE_TOL)
    g = 2.0 * ref / ref.numel()   # cotangent of mean(out ** 2)
    dp, dx = ft.fused_taylor_backward(packed, x, g, plan)
    rdp, rdx = ft.fused_taylor_backward_plain(packed, x, g, plan)
    sync()
    torch.testing.assert_close(dp, rdp, **GRAD_TOL)
    torch.testing.assert_close(dx, rdx, **GRAD_TOL)
    dp2, dx2 = ft.fused_taylor_backward(packed, x, g, plan)
    sync()
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2), \
        "backward not bitwise repeatable"
    errs = {"fwd": max_err(out, ref),
            "bwd": max(max_err(dp, rdp), max_err(dx, rdx))}
    times = {}
    if reps:
        times = {
            "fwd": time_ms(lambda: ft.fused_taylor_forward(packed, x, plan),
                           reps),
            "fwd_plain": time_ms(
                lambda: ft.fused_taylor_forward_plain(packed, x, plan), reps),
            "bwd": time_ms(
                lambda: ft.fused_taylor_backward(packed, x, g, plan), reps),
            "bwd_plain": time_ms(
                lambda: ft.fused_taylor_backward_plain(packed, x, g, plan),
                reps)}
    log(f"taylor fa fa fa f {features} n={n}: max|err| fwd "
        f"{errs['fwd']:.3e} bwd {errs['bwd']:.3e}, bitwise-repeatable"
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items()))
    return errs, times


def check_mlp(layout, features, in_dim, n, reps=0):
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops.fused_taylor import pack_weights
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, "Tanh", in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fm.MlpPlan(net.tokens, net.activations, net.layer_shapes, in_dim)
    x = torch.randn((n, in_dim), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        packed = pack_weights(net.params(), net.layer_names)
        out = fm.fused_mlp_forward(packed, x, plan)
        ref = fm.fused_mlp_forward_plain(packed, x, plan)
        sync()
        torch.testing.assert_close(out, ref, **VALUE_TOL)
        times = {}
        if reps:
            times = {
                "fwd": time_ms(lambda: fm.fused_mlp_forward(packed, x, plan),
                               reps),
                "fwd_plain": time_ms(
                    lambda: fm.fused_mlp_forward_plain(packed, x, plan),
                    reps)}
    err = max_err(out, ref)
    log(f"mlp {layout!r} {features} n={n}: max|err| {err:.3e}"
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items()))
    return err, times


def phase_kernels():
    taylor = [check_taylor([10, 12, 15, 1], 100, reps=200),
              check_taylor([10, 12, 15, 1], 1000, reps=200),
              check_taylor([64, 64, 64, 1], 65537, reps=10)]
    sync()
    mlp = [check_mlp("fa fa fa f", [10, 12, 15, 1], 2, 10000, reps=200)]
    for layout, features in [("fa fa f", [32, 32, 1]),
                             ("fa fa fa f", [10, 12, 15, 1]),
                             ("faR fa fa+ f", [16, 16, 16, 1])]:
        mlp.append(check_mlp(layout, features, 3, 2000))
        mlp.append(check_mlp(layout, features, 3, 1_048_576, reps=10))
    sync()
    return taylor, mlp


def _pde():
    from pydens_tpu_torch import D

    def pde(f, x, y):   # README.md, verbatim torch spelling
        return (D(D(f, x), x) + D(D(f, y), y)
                - 5 * torch.sin(np.pi * (x + y)))
    return pde


def _route_plain(model):
    """Send the model's Taylor traversal to the kernels' plain version (for
    the comparison only: the package never does this on a card)."""
    from pydens_tpu_torch.ops import fused_taylor as ft

    def taylor(net_params, xs, closure):
        plan = model._fused_taylor_plan(closure)
        packed = ft.pack_weights(net_params, model.layer_names)
        return ft.split_streams(
            ft.fused_taylor_forward_plain(packed, xs, plan), plan)

    model.network_apply_taylor = taylor


def timed_fit(solver):
    sync()
    t0 = time.perf_counter()
    solver.fit(batch_size=100, niters=1500, progress=False)
    sync()
    wall = time.perf_counter() - t0
    return wall, 1500 / wall


def phase_poisson():
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft

    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward,
                fm.fused_mlp_forward)
    for c in counters:
        c.launches = 0
    solver = Solver(_pde(), **README)
    assert solver.device.type == "cuda" and solver._plan_ok
    wall, rate = timed_fit(solver)
    xs = np.linspace(0, 1, 100, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    u = solver.predict(grid[:, 0:1], grid[:, 1:2])
    edge = solver.predict(np.zeros(100, np.float32), xs)
    launches = {c.__name__: c.launches for c in counters}
    losses = np.asarray(solver.losses)
    log(f"poisson fit (kernels): {wall:.3f} s, {rate:.1f} it/s, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.6f}; launches {launches}")
    assert losses.shape == (1500,) and np.isfinite(losses).all()
    assert losses[-1] < 0.01, losses[-1]
    assert launches["fused_taylor_forward"] >= 1500
    assert launches["fused_taylor_backward"] >= 1500
    assert launches["fused_mlp_forward"] >= 1
    assert u.shape == (10000, 1) and np.isfinite(u).all()
    np.testing.assert_allclose(edge, 1.0, atol=1e-5)
    model = solver.model
    with torch.no_grad():
        plain_u = model.apply(model.params, torch.as_tensor(
            grid, device=solver.device)).cpu().numpy()
    np.testing.assert_allclose(u, plain_u, **VALUE_TOL)
    log(f"predict 100x100: finite, boundary exact, max|kernel - plain| "
        f"{float(np.abs(u - plain_u).max()):.3e}")

    plain = Solver(_pde(), **README)
    _route_plain(plain.model)
    before = {c.__name__: c.launches for c in counters}
    p_wall, p_rate = timed_fit(plain)
    assert {c.__name__: c.launches for c in counters} == before
    p_losses = np.asarray(plain.losses)
    assert np.isfinite(p_losses).all() and p_losses[-1] < 0.01
    log(f"poisson fit (plain path): {p_wall:.3f} s, {p_rate:.1f} it/s, loss "
        f"{p_losses[0]:.5f} -> {p_losses[-1]:.6f}")
    sync()
    return launches, (wall, rate), (p_wall, p_rate)


def main():
    name, smi = phase_device()
    phase_build()
    sync()
    taylor, mlp = phase_kernels()
    launches, _, _ = phase_poisson()
    fwd_err = max(e["fwd"] for e, _ in taylor)
    bwd_err = max(e["bwd"] for e, _ in taylor)
    main_taylor = taylor[0][1]   # README shapes: n = 100
    main_mlp = mlp[0][1]         # README predict: 10,000 points
    kernels = [
        {"name": "fused_taylor_forward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_taylor.cu",
         "replaces": "pydens_tpu/ops/pallas_taylor.py:386",
         "launches": launches["fused_taylor_forward"],
         "max_abs_err": fwd_err, "ms": main_taylor["fwd"],
         "plain_ms": main_taylor["fwd_plain"]},
        {"name": "fused_taylor_backward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_taylor.cu",
         "replaces": "pydens_tpu/ops/pallas_taylor.py:428",
         "launches": launches["fused_taylor_backward"],
         "max_abs_err": bwd_err, "ms": main_taylor["bwd"],
         "plain_ms": main_taylor["bwd_plain"]},
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "pydens_tpu/ops/pallas_mlp.py:92",
         "launches": launches["fused_mlp_forward"],
         "max_abs_err": max(e for e, _ in mlp), "ms": main_mlp["fwd"],
         "plain_ms": main_mlp["fwd_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
