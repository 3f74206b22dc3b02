"""Smoke run of pydens_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # per-step profile of w1-w5 only

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card and its power limit; f32 matmuls and
   convolutions without TF32;
2. build: compiles the CUDA kernels of pydens_tpu_torch/csrc (timed);
3. kernels vs plain: every kernel against its plain PyTorch version on the
   card, at the README workload's shapes and at large ones (the 64-wide
   chain at 65,537 and 262,144 points, and a 6-stream heat closure), with
   timings and the backward's peak device memory at width 64;
4. the README 2D Poisson fit (1500 Adam steps, batch 100) and predict on a
   100 x 100 grid through the public Solver, with the launch counters
   showing that every step ran the fused Taylor kernels and predict the
   fused MLP kernel; the same fit with ``stop_on_nan=False``, in turns
   with the guarded one, for the divergence guard's cost; then the same fit
   with the kernels routed to their plain versions, for the comparison of
   iterations/s;
5. the wide fit: 2D Poisson, ``fa fa fa f`` [64, 64, 64, 1] Tanh, 200 Adam
   steps at batch 65,536 through the public Solver, in four arms: the
   kernels, the kernels with ``stop_on_nan=False``, the Taylor traversal
   routed to its plain version, and ``fit(fast_taps=False)`` (nested
   gradients); iterations/s and points/s of each;
6. the tutorials ``w2``-``w5`` of ``benchmarks/bench_loss_parity.py`` (ODE
   with an initial condition; heat 2D+t; the parametric family; the
   two-phase inverse ``V`` problem with a frozen variable and a
   constraint) through the public Solver at their full widths and
   iteration counts, with the device samplers; each holds its accuracy
   band (3x the worse of the two figures in ``BENCHMARKS.md:165-171``) and
   launches the Taylor kernels on every step and the MLP kernel in
   predict.

Phase 3 also checks every tutorial's Taylor chain at the batches of its
fits and the MLP kernel at the points of its predict calls
(``TUTORIAL_CHAINS``), and the MLP kernel at ``w3``'s layout on 1,024
points.

Prints one JSON line of per-kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1 and 2, then ``profile_steps``: one JSON line per
workload and guard setting (host ms per step, device ops and device busy
ms per step), and the card's name and power limit.
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
HEAT_CLOSURE = [(0,), (1,), (2,), (0, 0), (1, 1)]   # 2D + t: 6 streams
README = dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
              activation="Tanh", units=[10, 12, 15, 1])
WIDE = dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
            activation="Tanh", units=[64, 64, 64, 1])
WIDE_BATCH = 65536
WIDE_STEPS = 200
# Each tutorial's Taylor chain (network and closure of its equation), the
# batch sizes of its fits, and the points of its predict calls in phase 6.
TUTORIAL_CHAINS = {
    "w2": (dict(layout="fafaf", features=[12, 10, 1], act="Tanh", in_dim=1,
                closure=[(0,)]), (400,), 100),
    "w3": (dict(layout="fafaf", features=[30, 40, 1], act="Sigmoid",
                in_dim=4, closure=HEAT_CLOSURE), (1500,), 8),
    "w4": (dict(layout="fafaf", features=[20, 30, 1], act="Sigmoid",
                in_dim=2, closure=[(0,)]), (700,), 60),
    "w5": (dict(layout="fafaf", features=[20, 30, 1], act="Sigmoid",
                in_dim=1, closure=[(0,)]), (500, 100), 8),
}


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


def timed_pair(name, kernel, plain, reps):
    """``{name: kernel ms, name_plain: plain ms}``, each the mean of two
    timings taken in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return {name: (k1 + k2) / 2, f"{name}_plain": (p1 + p2) / 2}


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


def _taylor_case(layout, features, act, n, seed, closure, in_dim):
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_taylor as ft
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    plan = ft.TaylorPlan(net.tokens, net.activations, closure,
                         net.layer_shapes, in_dim)
    with torch.no_grad():
        packed = ft.pack_weights(net.params(), net.layer_names)
    x = torch.rand((n, in_dim), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    return plan, packed, x


def check_taylor(features, n, seed=0, reps=0, closure=POISSON_CLOSURE,
                 in_dim=2, memory=False, layout="fa fa fa f", act="Tanh"):
    """Forward and backward kernels against the plain autograd path; with
    ``memory``, the backward's peak device memory beyond its inputs."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, packed, x = _taylor_case(layout, features, act, n, seed, closure,
                                   in_dim)
    out = ft.fused_taylor_forward(packed, x, plan)
    ref = ft.fused_taylor_forward_plain(packed, x, plan)
    sync()
    torch.testing.assert_close(out, ref, **VALUE_TOL)
    fwd_err = max_err(out, ref)
    g = 2.0 * ref / ref.numel()   # cotangent of mean(out ** 2)
    del out
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dp, dx = ft.fused_taylor_backward(packed, x, g, plan)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    rdp, rdx = ft.fused_taylor_backward_plain(packed, x, g, plan)
    sync()
    torch.testing.assert_close(dp, rdp, **GRAD_TOL)
    torch.testing.assert_close(dx, rdx, **GRAD_TOL)
    dp2, dx2 = ft.fused_taylor_backward(packed, x, g, plan)
    sync()
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2), \
        "backward not bitwise repeatable"
    errs = {"fwd": fwd_err, "bwd": max(max_err(dp, rdp), max_err(dx, rdx))}
    times = {}
    if reps:
        times = timed_pair(
            "fwd", lambda: ft.fused_taylor_forward(packed, x, plan),
            lambda: ft.fused_taylor_forward_plain(packed, x, plan), reps)
        times.update(timed_pair(
            "bwd", lambda: ft.fused_taylor_backward(packed, x, g, plan),
            lambda: ft.fused_taylor_backward_plain(packed, x, g, plan), reps))
    mem = ""
    if memory:
        _, save_f, part_f = plan.backward_workspace(
            n, torch.cuda.get_device_properties(0).multi_processor_count)
        mem = (f", backward peak memory {peak / 2**20:.2f} MiB beyond its "
               f"inputs (outputs {(dp.numel() + dx.numel()) * 4 / 2**20:.2f}"
               f" MiB, workspace {(save_f + part_f) * 4 / 2**20:.2f} MiB)")
    log(f"taylor {layout!r} {act} {features} in_dim {in_dim} closure "
        f"{len(closure)} n={n}: "
        f"max|err| fwd {errs['fwd']:.3e} bwd {errs['bwd']:.3e}, "
        "bitwise-repeatable"
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items()) + mem)
    return errs, times


def check_mlp(layout, features, in_dim, n, reps=0, act="Tanh"):
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops.fused_taylor import pack_weights
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
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
    log(f"mlp {layout!r} {act} {features} n={n}: max|err| {err:.3e}"
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items()))
    return err, times


def phase_kernels():
    wide = [64, 64, 64, 1]
    taylor = [check_taylor([10, 12, 15, 1], 100, reps=200),
              check_taylor([10, 12, 15, 1], 1000, reps=200),
              check_taylor(wide, 65537, reps=20, memory=True),
              check_taylor(wide, 262144, reps=5, memory=True),
              check_taylor(wide, 65537, reps=10, closure=HEAT_CLOSURE,
                           in_dim=3, memory=True)]
    # The tutorials' shapes, keyed "w<k>_n<points>".
    tut_taylor = {f"{w}_n{n}": check_taylor(n=n, reps=200, **chain)
                  for w, (chain, batches, _) in TUTORIAL_CHAINS.items()
                  for n in batches}
    sync()
    mlp = [check_mlp("fa fa fa f", [10, 12, 15, 1], 2, 10000, reps=200),
           check_mlp("fafaf", [30, 40, 1], 4, 1024, reps=200,
                     act="Sigmoid")]
    tut_mlp = {f"{w}_n{n}": check_mlp(chain["layout"], chain["features"],
                                      chain["in_dim"], n, reps=200,
                                      act=chain["act"])
               for w, (chain, _, n) in TUTORIAL_CHAINS.items()}
    for layout, features in [("fa fa f", [32, 32, 1]),
                             ("fa fa fa f", [10, 12, 15, 1]),
                             ("faR fa fa+ f", [16, 16, 16, 1])]:
        mlp.append(check_mlp(layout, features, 3, 2000))
        mlp.append(check_mlp(layout, features, 3, 1_048_576, reps=10))
    sync()
    return taylor, tut_taylor, mlp, tut_mlp


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


def timed_fit(solver, **kwargs):
    sync()
    t0 = time.perf_counter()
    solver.fit(batch_size=100, niters=1500, progress=False, **kwargs)
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

    # The divergence guard's cost: the same fit with stop_on_nan=False, in
    # turns with the guarded one (guarded above, off, off, guarded).
    rates = {True: [rate], False: []}
    for guard in (False, False, True):
        other = Solver(_pde(), **README)
        rates[guard].append(timed_fit(other, stop_on_nan=guard)[1])
        same = np.array_equal(np.asarray(other.losses), losses)
        log(f"poisson fit (kernels, stop_on_nan={guard}): "
            f"{rates[guard][-1]:.1f} it/s, losses bitwise equal to the "
            f"first fit's: {same}")
        np.testing.assert_allclose(other.losses[-1], losses[-1], rtol=1e-5)
        del other
    guard_rates = {g: float(np.mean(r)) for g, r in rates.items()}
    log(f"poisson fit guard cost: {guard_rates[True]:.1f} it/s guarded, "
        f"{guard_rates[False]:.1f} it/s unguarded (mean of two each, in "
        "turns)")

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


def _falling(losses):
    k = max(1, len(losses) // 10)
    return (np.isfinite(losses).all()
            and losses[-k:].mean() < losses[:k].mean())


def phase_wide_fit():
    """The 64-wide Poisson fit in four arms: kernels; kernels with
    ``stop_on_nan=False`` (the guard's cost, in turns with the first arm:
    kernels, off, off, kernels); the Taylor traversal on its plain version;
    nested gradients (``fast_taps=False``).  Each arm warms up for 5 steps,
    then runs WIDE_STEPS timed steps."""
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.ops import fused_taylor as ft
    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward)
    rates = {}
    for arm in ("kernels", "unguarded", "unguarded", "kernels", "plain",
                "nested"):
        solver = Solver(_pde(), seed=0, **WIDE)
        assert solver.device.type == "cuda" and solver._plan_ok
        if arm == "plain":
            _route_plain(solver.model)
        kw = dict(batch_size=WIDE_BATCH, progress=False,
                  fast_taps=arm != "nested", stop_on_nan=arm != "unguarded")
        solver.fit(niters=5, **kw)
        for c in counters:
            c.launches = 0
        sync()
        t0 = time.perf_counter()
        solver.fit(niters=WIDE_STEPS, **kw)
        sync()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        losses = np.asarray(solver.losses[-WIDE_STEPS:])
        rate = WIDE_STEPS / wall
        rates.setdefault(arm, []).append(rate)
        log(f"wide fit ({arm}): {WIDE_STEPS} steps at batch {WIDE_BATCH} in "
            f"{wall:.3f} s, {rate:.2f} it/s, {rate * WIDE_BATCH:.0f} "
            f"points/s, loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches "
            f"{launches}")
        assert losses.shape == (WIDE_STEPS,) and _falling(losses), arm
        if arm in ("kernels", "unguarded"):
            assert min(launches.values()) >= WIDE_STEPS, launches
        else:
            assert max(launches.values()) == 0, launches
        del solver
        torch.cuda.empty_cache()
    log(f"wide fit guard cost: {np.mean(rates['kernels']):.2f} it/s "
        f"guarded, {np.mean(rates['unguarded']):.2f} it/s unguarded (mean of "
        "two each, in turns)")


def _tutorial(name):
    """``(equation, Solver kwargs, [(hook, fit kwargs), ...])`` of one
    tutorial, as ``benchmarks/bench_loss_parity.py`` defines it; ``hook``
    runs on the model before its fit; ``w1`` is the README fit of phase 4."""
    from pydens_tpu_torch import D, V, NS
    if name == "w1":
        return _pde(), dict(README), [
            (None, dict(niters=1500, batch_size=100))]
    if name == "w2":
        def ode(f, x):
            return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
        return ode, dict(ndims=1, initial_condition=.5, activation="Tanh",
                         layout="fafaf", features=[12, 10, 1]), [
            (None, dict(niters=500, batch_size=400, lr=0.02))]
    if name == "w3":
        def pde(f, x, y, t, a):
            return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)
        sampler = (NS("u", dim=2, seed=0) & NS("u", low=0, high=.5, seed=1)
                   & NS("u", low=.1, high=4, seed=2))
        return pde, dict(ndims=3, nparams=1,
                         initial_condition=lambda x, y: 10 * x * y
                         * (1 - x) * (1 - y),
                         boundary_condition=0, layout="fafaf",
                         features=[30, 40, 1], activation="Sigmoid"), [
            (None, dict(niters=1000, batch_size=1500, lr=0.001,
                        sampler=sampler))]
    if name == "w4":
        def odeparam(f, x, e):
            return D(f, x) - e * np.pi * torch.cos(e * np.pi * x)
        sampler = NS("u", seed=0) & NS("u", low=.5, high=5.5, seed=1)
        return odeparam, dict(ndims=1, initial_condition=2.0, nparams=1), [
            (None, dict(niters=7000, batch_size=700, lr=0.01,
                        sampler=sampler))]

    def odevar(f, x):
        return (D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
                + V("new_var", data=np.array([1.0])))
    return odevar, dict(ndims=1, initial_condition=1,
                        constraints=lambda f, x: f(np.array([0.5]))), [
        (lambda m: m.freeze_trainable(variables=("new_var",)),
         dict(niters=400, batch_size=500, lr=0.1)),
        (lambda m: m.unfreeze_trainable(variables=["new_var"]),
         dict(niters=300, batch_size=100, lr=0.1,
              loss_terms=["equation", "constraint_0"]))]


# Accuracy bands: 3x the worse of pydens_tpu's and the torch reference
# loop's figures in BENCHMARKS.md:165-171 (w2 and w4: max analytic error;
# w3: mean of the last 50 training losses; w5: |new_var - 2|).
TUTORIAL_BANDS = {"w2": 0.0069, "w3": 19.9, "w4": 0.087, "w5": 0.018}


def tutorial_metric(name, solver):
    """The quantity ``TUTORIAL_BANDS`` bounds, for a trained solver."""
    if name == "w2":
        xs = np.linspace(0, 1, 100, dtype=np.float32)
        return float(np.abs(solver.predict(xs).ravel()
                            - (np.sin(2 * np.pi * xs) + .5)).max())
    if name == "w3":
        solver.predict(np.full((8, 4), .25, np.float32))   # runs the MLP
        return float(np.mean(solver.losses[-50:]))
    if name == "w4":
        xs = np.linspace(0, 1, 60, dtype=np.float32)
        return max(float(np.abs(solver.predict(xs, e).ravel()
                                - (np.sin(e * np.pi * xs) + 2)).max())
                   for e in (1.0, 2.0))
    solver.predict(np.linspace(0, 1, 8, dtype=np.float32))
    return abs(solver.params["variables"]["new_var"].item() - 2.0)


def run_tutorial(name, device):
    """Build and train one tutorial through the public Solver; returns
    ``(solver, steps, wall seconds)``."""
    from pydens_tpu_torch import Solver
    eq, kw, fits = _tutorial(name)
    solver = Solver(eq, seed=0, device=device, **kw)
    steps = 0
    t0 = time.perf_counter()
    for hook, fit in fits:
        if hook is not None:
            hook(solver.model)
        solver.fit(progress=False, **fit)
        steps += fit["niters"]
    if solver.device.type == "cuda":
        sync()
    return solver, steps, time.perf_counter() - t0


def phase_tutorials():
    """w2-w5 on the card, each with the launch counters set to 0 just
    before it and read just after its predict."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward,
                fm.fused_mlp_forward)
    results = {}
    for name in ("w2", "w3", "w4", "w5"):
        for c in counters:
            c.launches = 0
        solver, steps, wall = run_tutorial(name, "cuda")
        assert solver.device.type == "cuda" and solver._plan_ok
        metric = tutorial_metric(name, solver)
        launches = {c.__name__: c.launches for c in counters}
        losses = np.asarray(solver.losses)
        log(f"tutorial {name}: {steps} steps in {wall:.3f} s, "
            f"{steps / wall:.1f} it/s, loss {losses[0]:.5f} -> "
            f"{losses[-1]:.6f}, metric {metric:.6f} (band "
            f"{TUTORIAL_BANDS[name]}); launches {launches}")
        assert losses.shape == (steps,) and _falling(losses), name
        assert launches["fused_taylor_forward"] >= steps, launches
        assert launches["fused_taylor_backward"] >= steps, launches
        assert launches["fused_mlp_forward"] >= 1, launches
        assert metric < TUTORIAL_BANDS[name], (name, metric)
        results[name] = launches
        del solver
        torch.cuda.empty_cache()
    return results


def profile_steps(steps=50, warmup=20):
    """Per-step cost of the last fit of ``w1``-``w5``, with the guard on and
    off: host ms per step (host clock over ``steps`` unprofiled steps ending
    in a synchronize) and, from ``torch.profiler`` over ``steps`` more, the
    device ops per step and their summed device time (kernels, copies and
    fills).  Each fit warms up for ``warmup`` steps; a tutorial's earlier
    fits run in full first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pydens_tpu_torch import Solver
    rows = []
    for name in ("w1", "w2", "w3", "w4", "w5"):
        for guard in (True, False):
            eq, kw, fits = _tutorial(name)
            solver = Solver(eq, seed=0, device="cuda", **kw)
            for i, (hook, fit) in enumerate(fits):
                if hook is not None:
                    hook(solver.model)
                if i < len(fits) - 1:
                    solver.fit(progress=False, **fit)
            fit = dict(fits[-1][1], progress=False, stop_on_nan=guard)
            solver.fit(**dict(fit, niters=warmup))
            sync()
            t0 = time.perf_counter()
            solver.fit(**dict(fit, niters=steps))
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3 / steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solver.fit(**dict(fit, niters=steps))
                sync()
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
            row = dict(workload=name, stop_on_nan=guard, step_ms=step_ms,
                       device_busy_ms=busy_ms,
                       busy_share=busy_ms / step_ms,
                       device_ops=len(dev) / steps)
            log(json.dumps(row))
            rows.append(row)
            del solver
            torch.cuda.empty_cache()
    return rows


def main():
    name, smi = phase_device()
    phase_build()
    sync()
    if sys.argv[1:] == ["--profile"]:
        profile_steps()
        print(smi, flush=True)
        return 0
    taylor, tut_taylor, mlp, tut_mlp = phase_kernels()
    launches, _, _ = phase_poisson()
    phase_wide_fit()
    tutorials = phase_tutorials()
    path_launches = {k: {"w1": launches[k],
                         **{w: t[k] for w, t in tutorials.items()}}
                     for k in launches}
    all_taylor = taylor + list(tut_taylor.values())
    fwd_err = max(e["fwd"] for e, _ in all_taylor)
    bwd_err = max(e["bwd"] for e, _ in all_taylor)
    main_taylor = taylor[0][1]   # README shapes: n = 100
    main_mlp = mlp[0][1]         # README predict: 10,000 points
    shapes = {"wide": taylor[2][1],   # 64-wide chain, n = 65,537
              **{key: times for key, (_, times) in tut_taylor.items()}}
    mlp_shapes = {"w3_layout_n1024": mlp[1][1],
                  **{key: times for key, (_, times) in tut_mlp.items()}}

    def shape_times(key):
        return {f"{tag}_{kind}ms": times[key + suffix]
                for tag, times in shapes.items()
                for kind, suffix in (("", ""), ("plain_", "_plain"))}

    kernels = [
        {"name": "fused_taylor_forward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_taylor.cu",
         "replaces": "pydens_tpu/ops/pallas_taylor.py:386",
         "launches": launches["fused_taylor_forward"],
         "max_abs_err": fwd_err, "ms": main_taylor["fwd"],
         "plain_ms": main_taylor["fwd_plain"], **shape_times("fwd"),
         "path_launches": path_launches["fused_taylor_forward"]},
        {"name": "fused_taylor_backward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_taylor.cu",
         "replaces": "pydens_tpu/ops/pallas_taylor.py:428",
         "launches": launches["fused_taylor_backward"],
         "max_abs_err": bwd_err, "ms": main_taylor["bwd"],
         "plain_ms": main_taylor["bwd_plain"], **shape_times("bwd"),
         "path_launches": path_launches["fused_taylor_backward"]},
        {"name": "fused_mlp_forward", "route": "cuda",
         "source": "pydens_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "pydens_tpu/ops/pallas_mlp.py:92",
         "launches": launches["fused_mlp_forward"],
         "max_abs_err": max(e for e, _ in mlp + list(tut_mlp.values())),
         "ms": main_mlp["fwd"], "plain_ms": main_mlp["fwd_plain"],
         **{f"{tag}_{kind}ms": times[f"fwd{suffix}"]
            for tag, times in mlp_shapes.items()
            for kind, suffix in (("", ""), ("plain_", "_plain"))},
         "path_launches": path_launches["fused_mlp_forward"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
