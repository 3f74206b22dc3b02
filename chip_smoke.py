"""Smoke run of pydens_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # per-step profile of w1-w5 only
    python3 chip_smoke.py --mlp-turns OLD.cu   # MLP kernel: OLD.cu vs this

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card and its power limit; f32 matmuls and
   convolutions without TF32;
2. build: compiles the CUDA kernels of pydens_tpu_torch/csrc (timed);
3. kernels vs plain: every kernel against its plain PyTorch version on the
   card, at the README workload's shapes and at large ones (the 64-wide
   chain at 65,537 and 262,144 points, and a 6-stream heat closure; the
   MLP at 1,048,576 points on four layouts, at a ragged n and at an n that
   takes the persistent blocks around more than once), with timings, each
   shape's bound and share of it, and the backward's peak device memory at
   width 64;
4. the README 2D Poisson fit (1500 Adam steps, batch 100) and predict on a
   100 x 100 grid through the public Solver, with the launch counters
   showing that every step ran the fused Taylor kernels and predict the
   fused MLP kernel; a dense predict on a 1024 x 1024 grid, split into its
   parts (``Solver.predict``, ``predict_apply`` on a device tensor, the
   kernel alone); the same fit with ``stop_on_nan=False``, in turns with
   the guarded one, for the divergence guard's cost; then the same fit
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
   predict; ``w3`` then predicts on a 1024 x 1024 (x, y) grid as in
   phase 4.

Phase 3 also checks every tutorial's Taylor chain at the batches of its
fits and the MLP kernel at the points of its predict calls
(``TUTORIAL_CHAINS``), and the MLP kernel at ``w3``'s layout on 1,024
points.

Prints one JSON line of per-kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1 and 2, then ``profile_steps``: one JSON line per
workload and guard setting (host ms per step, device ops and device busy
ms per step), and the card's name and power limit.

``--mlp-turns OLD.cu`` runs phases 1 and 2, then ``mlp_turns``: the fused
MLP kernel of an earlier ``csrc/fused_mlp.cu`` (the one-thread-per-point
design, whose C entry and op table it knows) built from ``OLD.cu`` into
``build/mlp_turns/``, timed in turns with this tree's kernel, and this
tree's kernel's SASS instruction counts (``cuobjdump``).  To take the
earlier source from git: ``git show <commit>:pydens_tpu_torch/csrc/fused_mlp.cu
> build/fused_mlp_old.cu``.

Bounds: the least time the card could take for a kernel's work, the larger
of its FMAs (2 FLOPs each) over the H100 SXM's 67 TFLOP/s f32 peak and its
bytes (each input read once, each output written once) over 3.35 TB/s; the
Taylor forward counts the products of all its streams, the backward twice
that (its recompute is the kernel's own choice and not counted).
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
DENSE_GRID = 1024           # dense predicts: DENSE_GRID ** 2 points
# The MLP layouts timed at 1,048,576 points, 3 inputs, Tanh: those of
# tests/test_pallas_mlp.py and the 64-wide chain.
MLP_LAYOUTS = [("l32x32", "fa fa f", [32, 32, 1]),
               ("l10x12x15", "fa fa fa f", [10, 12, 15, 1]),
               ("skip16", "faR fa fa+ f", [16, 16, 16, 1]),
               ("wide64", "fa fa fa f", [64, 64, 64, 1])]
F32_FLOPS = 67e12           # H100 SXM f32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
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


def _tol_used(out, ref):
    """The largest ``|out - ref| / (atol + rtol |ref|)`` at VALUE_TOL."""
    return float(((out - ref).abs() / (VALUE_TOL["atol"] + VALUE_TOL["rtol"]
                                        * ref.abs())).max())


def bound(fmas, nbytes):
    """``(ms, "operations" or "bytes", work)``: the least time the card
    could take for ``fmas`` f32 FMAs and ``nbytes`` of device memory
    traffic, and the two counts as text."""
    ops_ms = 2 * fmas / F32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    work = f"{fmas / 1e6:.3f} M FMAs, {nbytes / 1e6:.3f} MB"
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", work
    return bytes_ms, "bytes", work


def _products(ops):
    return sum(op[1] * op[2] for op in ops if op[0] == "dense")


def taylor_bounds(plan, n):
    """Bounds of the Taylor forward (the products of all streams; x and the
    weights in, the streams out) and backward (twice the products; x, the
    weights and the cotangent in, dW and dx out)."""
    fmas = n * plan.n_streams * _products(plan.ops)
    fwd_bytes = 4 * (n * plan.in_dim + plan.n_params
                     + n * plan.n_streams * plan.out_dim)
    bwd_bytes = fwd_bytes + 4 * (plan.n_params + n * plan.in_dim)
    return {"fwd": bound(fmas, fwd_bytes), "bwd": bound(2 * fmas, bwd_bytes)}


def mlp_bound(plan, n):
    """Bound of the MLP forward: its products; x and the weights in, the
    output out."""
    return bound(n * _products(plan.ops),
                 4 * (n * (plan.in_dim + plan.out_dim) + plan.n_params))


def mlp_threads_busy(plan):
    """Share of the thread slots of the dense layers' register tiles that do
    work, weighted by each layer's FMAs (csrc/fused_mlp.cu: a thread owns
    4 points x 4 features; THREADS threads walk a tile's items)."""
    from pydens_tpu_torch.ops.fused_mlp import THREADS
    busy = total = 0
    for op in plan.ops:
        if op[0] == "dense":
            items = -(-op[2] // 4) * (plan.tile // 4)
            rounds = -(-items // THREADS)
            busy += op[1] * op[2] * items / (rounds * THREADS)
            total += op[1] * op[2]
    return busy / total


def _share(ms, bound_ms):
    return f"bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}% of it"


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
    bounds = taylor_bounds(plan, n)
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
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items())
        + "".join(f"; {k} {work}, {_share(times[k], b)} ({by})"
                  for k, (b, by, work) in bounds.items() if k in times)
        + mem)
    for k, (b, by, _) in bounds.items():
        times[f"{k}_bound"], times[f"{k}_bound_by"] = b, by
    return errs, times


def _mlp_case(layout, features, in_dim, n, act="Tanh"):
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
    return plan, packed, x


def mlp_grid(plan):
    """``(grid, tile)`` of the MLP kernel's persistent launch at large n."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops._build import load_library
    dev = torch.device("cuda", 0)
    per_sm = fm._blocks_per_sm(load_library(), plan, dev)
    return (torch.cuda.get_device_properties(0).multi_processor_count
            * per_sm, plan.tile)


def check_mlp(layout, features, in_dim, n, reps=0, act="Tanh"):
    """The MLP kernel against its plain version; with ``reps``, both timed
    in turns.  Returns ``(max error, times)``; ``times`` holds the bound."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    if n == "passes":
        plan, _, _ = _mlp_case(layout, features, in_dim, 1, act)
        grid, tile = mlp_grid(plan)
        n = 3 * grid * tile + 77
    plan, packed, x = _mlp_case(layout, features, in_dim, n, act)
    with torch.no_grad():
        out = fm.fused_mlp_forward(packed, x, plan)
        ref = fm.fused_mlp_forward_plain(packed, x, plan)
        sync()
        torch.testing.assert_close(out, ref, **VALUE_TOL)
        times = {}
        if reps:
            times = timed_pair(
                "fwd", lambda: fm.fused_mlp_forward(packed, x, plan),
                lambda: fm.fused_mlp_forward_plain(packed, x, plan), reps)
    err = max_err(out, ref)
    bound_ms, by, work = mlp_bound(plan, n)
    grid, tile = mlp_grid(plan)
    log(f"mlp {layout!r} {act} {features} in_dim {in_dim} n={n}: max|err| "
        f"{err:.3e} ({100 * _tol_used(out, ref):.1f}% of VALUE_TOL)"
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items())
        + f"; {work}"
        + (f", {_share(times['fwd'], bound_ms)} ({by})" if times else
           f", bound {bound_ms * 1e3:.2f} us ({by})")
        + f"; tile {tile}, {grid} resident blocks, the persistent loop turns "
        f"{-(-n // tile) / grid:.2f} times; threads busy "
        f"{100 * mlp_threads_busy(plan):.0f}%")
    times["fwd_bound"], times["fwd_bound_by"] = bound_ms, by
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
    # The MLP shapes, keyed by tag; "readme_n10000" is the README predict.
    mlp = {"readme_n10000": check_mlp("fa fa fa f", [10, 12, 15, 1], 2,
                                      10000, reps=200),
           "w3_layout_n1024": check_mlp("fafaf", [30, 40, 1], 4, 1024,
                                        reps=200, act="Sigmoid")}
    tut_mlp = {f"{w}_n{n}": check_mlp(chain["layout"], chain["features"],
                                      chain["in_dim"], n, reps=200,
                                      act=chain["act"])
               for w, (chain, _, n) in TUTORIAL_CHAINS.items()}
    for tag, layout, features in MLP_LAYOUTS:
        check_mlp(layout, features, 3, 2000)
        mlp[f"{tag}_n1048576"] = check_mlp(layout, features, 3, 1_048_576,
                                           reps=10)
    # A ragged n (not a multiple of the tile), and an n that takes every
    # persistent block around its loop three times and more.
    mlp["readme_layout_ragged"] = check_mlp("fa fa fa f", [10, 12, 15, 1], 3,
                                            1_000_003, reps=10)
    mlp["readme_layout_passes"] = check_mlp("fa fa fa f", [10, 12, 15, 1], 3,
                                            "passes", reps=10)
    mlp["wide64_passes"] = check_mlp("fa fa fa f", [64, 64, 64, 1], 3,
                                     "passes", reps=10)
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


def dense_predict(solver, grid, tag, reps=5):
    """A dense predict of a trained solver on ``grid`` (numpy, ``(N,
    total)``), split into its parts: ``Solver.predict`` (host clock ending in
    a synchronize, mean of ``reps`` after a warm-up), and within it the
    input normalisation, the copy to the card, ``predict_apply`` and the
    copy back (host clock, one call each); ``Model.predict_apply`` on a
    device tensor and the kernel alone (CUDA events).  Asserts one MLP
    launch per ``Solver.predict`` and the kernel within VALUE_TOL of its
    plain version."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops.fused_taylor import pack_weights
    model = solver.model
    before = fm.fused_mlp_forward.launches
    u = solver.predict(grid)
    assert fm.fused_mlp_forward.launches - before == 1
    assert u.shape == (grid.shape[0], 1) and np.isfinite(u).all()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        solver.predict(grid)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    split = {}
    t0 = time.perf_counter()
    xn = solver._normalize_inputs((grid,))
    split["normalize"] = (time.perf_counter() - t0) * 1e3
    sync()
    t0 = time.perf_counter()
    x = torch.as_tensor(xn, dtype=model.dtype, device=solver.device)
    sync()
    split["to_card"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = model.predict_apply(model.params, x)
    sync()
    split["predict_apply"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out.cpu().numpy()
    split["to_host"] = (time.perf_counter() - t0) * 1e3
    plan = model._mlp_plan
    with torch.no_grad():
        packed = pack_weights(model.params["net"], model.layer_names)
        kernel = fm.fused_mlp_forward(packed, x, plan)
        plain = fm.fused_mlp_forward_plain(packed, x, plan)
        sync()
        torch.testing.assert_close(kernel, plain, **VALUE_TOL)
        apply_ms = time_ms(lambda: model.predict_apply(model.params, x), 20)
        times = timed_pair(
            "kernel", lambda: fm.fused_mlp_forward(packed, x, plan),
            lambda: fm.fused_mlp_forward_plain(packed, x, plan), 20)
    bound_ms, by, _ = mlp_bound(plan, x.shape[0])
    log(f"dense predict {tag}, {grid.shape[0]} points: Solver.predict "
        f"{np.mean(walls):.3f} ms (host clock, mean of {reps}; min "
        f"{min(walls):.3f}), one call split: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; predict_apply on the card {apply_ms:.4f} ms, kernel "
        f"{times['kernel']:.4f} ms (plain {times['kernel_plain']:.4f} ms; "
        f"{_share(times['kernel'], bound_ms)} ({by})); MLP launches per "
        f"Solver.predict 1; max|kernel - plain| "
        f"{max_err(kernel, plain):.3e} (max|plain| "
        f"{float(plain.abs().max()):.3e}; the worst point uses "
        f"{100 * _tol_used(kernel, plain):.1f}% of VALUE_TOL)")
    return dict(predict_ms=float(np.mean(walls)), apply_ms=apply_ms,
                kernel_ms=times["kernel"], **split)


def _grid(*fixed):
    """A DENSE_GRID x DENSE_GRID grid over (x, y) in [0, 1]^2, with the
    columns ``fixed`` appended at constant values."""
    xs = np.linspace(0, 1, DENSE_GRID, dtype=np.float32)
    cols = [c.reshape(-1) for c in np.meshgrid(xs, xs, indexing="ij")]
    cols += [np.full(DENSE_GRID ** 2, v, np.float32) for v in fixed]
    return np.stack(cols, -1)


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
    dense_predict(solver, _grid(), "README")

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
        if name == "w3":   # (x, y) at t = 0.25, a = 1
            dense_predict(solver, _grid(0.25, 1.0), "w3")
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


def _load_old_mlp(source):
    """The earlier MLP kernel built from ``source`` into build/mlp_turns/,
    with the C entry it has: pdt_mlp_forward(x, w, tab, out, n, P, wmax,
    max_stack, out_dim, stream)."""
    import ctypes
    from pathlib import Path
    from pydens_tpu_torch.ops._build import _NVCC_FLAGS, _nvcc
    out_dir = Path(__file__).resolve().parent / "build" / "mlp_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / "libmlp_old.so"
    subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(target), str(source)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pdt_mlp_forward.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.pdt_mlp_forward.restype = ctypes.c_int
    return lib


def _raw_mlp_calls(old, packed, x, plan):
    """``(old, new)``: calls of the earlier and of this tree's C entry on
    the same inputs, each into an output of its own allocated once, with no
    wrapper around them."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops._build import load_library
    kinds = {"dense": 0, "act": 1, "push": 2, "add": 3}
    table = torch.tensor(
        [len(plan.ops), plan.in_dim, plan.wmax, plan.max_stack]
        + [v for op in plan.ops for v in (kinds[op[0]], *op[1:])],
        dtype=torch.int32, device=x.device)
    lib, n = load_library(), x.shape[0]
    grid = plan.launch_shape(
        n, torch.cuda.get_device_properties(0).multi_processor_count,
        fm._blocks_per_sm(lib, plan, x.device))
    outs = [torch.empty((n, plan.out_dim), device=x.device) for _ in "on"]
    stream = torch.cuda.current_stream().cuda_stream

    def old_call():
        assert old.pdt_mlp_forward(
            x.data_ptr(), packed.data_ptr(), table.data_ptr(),
            outs[0].data_ptr(), n, plan.n_params, plan.wmax, plan.max_stack,
            plan.out_dim, stream) == 0
        return outs[0]

    def new_call():
        assert lib.pdt_mlp_forward(
            x.data_ptr(), packed.data_ptr(),
            plan.device_table(x.device).data_ptr(), outs[1].data_ptr(), n,
            *plan.kernel_args(), plan.out_dim, grid, stream) == 0
        return outs[1]
    return old_call, new_call


def sass_counts(lib_path, kernel="mlp_fwd_kernelILi128E"):
    """Per basic block of ``kernel``'s SASS (``cuobjdump -sass``) that runs
    FFMA or MUFU: its opcode counts.  A block starts at a label or a branch
    target and ends after a branch."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    body = text[text.index(kernel):]
    nxt = body.find("Function :", 10)
    body = body[:nxt if nxt > 0 else len(body)]
    instr = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
    rows, targets = [], set()
    for line in body.splitlines():
        if re.match(r"\s*\.L\w*:", line):
            rows.append(("label", None, ""))
            continue
        m = instr.match(line)
        if m:
            rows.append((int(m.group(1), 16), m.group(3), m.group(4)))
            if m.group(3).startswith(("BRA", "BRX", "CALL")):
                targets.update(int(t, 16) for t in
                               re.findall(r"0x([0-9a-f]+)", m.group(4)))
    blocks, cur = [], {}
    for addr, op, _ in rows:
        if addr == "label" or addr in targets:
            blocks.append(cur)
            cur = {}
            if addr == "label":
                continue
        cur[op] = cur.get(op, 0) + 1
        if op.startswith(("BRA", "EXIT", "RET")):
            blocks.append(cur)
            cur = {}
    blocks.append(cur)
    return [b for b in blocks
            if any(k.startswith(("FFMA", "MUFU")) for k in b)]


def mlp_turns(old_source, reps=20):
    """The MLP kernel of an earlier csrc/fused_mlp.cu (``old_source``)
    against this tree's, in turns (old, new, new, old; CUDA events, ``reps``
    calls each of the bare C entries) at the three layouts of
    tests/test_pallas_mlp.py on 1,048,576 points and at the README predict
    (10,000 points), and this tree's kernel through its wrapper; then this
    tree's kernel's SASS: for each block that runs FFMA or MUFU, its opcode
    counts, and from the dense loops and the fused activations the
    instructions per point of each layout."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops._build import load_library
    old = _load_old_mlp(old_source)
    cases = [(tag, layout, features, 3, 1_048_576)
             for tag, layout, features in MLP_LAYOUTS[:3]]
    cases.append(("readme_predict", "fa fa fa f", [10, 12, 15, 1], 2, 10000))
    rows = {}
    for tag, layout, features, in_dim, n in cases:
        plan, packed, x = _mlp_case(layout, features, in_dim, n)
        old_call, new_call = _raw_mlp_calls(old, packed, x, plan)
        with torch.no_grad():
            ref = fm.fused_mlp_forward_plain(packed, x, plan)
            for fn in (old_call, new_call):
                torch.testing.assert_close(fn(), ref, **VALUE_TOL)
            o1, n1, n2, o2 = (time_ms(f, reps) for f in (
                old_call, new_call, new_call, old_call))
            wrapped = time_ms(lambda: fm.fused_mlp_forward(packed, x, plan),
                              reps)
        bound_ms, by, _ = mlp_bound(plan, n)
        rows[tag] = dict(old=[o1, o2], new=[n1, n2], wrapper=wrapped,
                         bound_ms=bound_ms, bound_by=by)
        log(f"mlp turns {tag} {features} n={n}: old {o1:.4f} / {o2:.4f} ms, "
            f"new {n1:.4f} / {n2:.4f} ms (C entries, old, new, new, old), "
            f"speed-up {(o1 + o2) / (n1 + n2):.2f}x; new "
            f"{_share((n1 + n2) / 2, bound_ms)} ({by}); through "
            f"fused_mlp_forward {wrapped:.4f} ms")
    blocks = sass_counts(load_library().path)
    for i, b in enumerate(blocks):
        log(f"sass block {i}: {sum(b.values())} instructions, "
            + ", ".join(f"{k} {v}" for k, v in sorted(b.items())))
    # The dense loop (unrolled 4 times: 64 FFMA) and the fused activations
    # (the blocks with MUFU.EX2).
    loop = next(b for b in blocks if b.get("FFMA") == 64 and b.get("LDS.128"))
    per_fma = sum(loop.values()) / 64
    acts = [b for b in blocks if b.get("MUFU.EX2")]
    per_act = (sum(sum(b.values()) for b in acts)
               / sum(b["MUFU.EX2"] for b in acts))
    clock = F32_FLOPS / 2 / (132 * 128)   # lanes x clock = FMA rate
    for tag, layout, features, in_dim, n in cases:
        plan, _, _ = _mlp_case(layout, features, in_dim, 1)
        fmas = sum(op[1] * -(-op[2] // 4) * 4 for op in plan.ops
                   if op[0] == "dense")
        n_act = sum(op[1] for op in plan.ops if op[0] == "act")
        instr = fmas * per_fma + n_act * per_act
        issue_ms = n * instr / (132 * 128 * clock) * 1e3
        mufu_ms = n * 2 * n_act / (132 * 16 * clock) * 1e3
        mean_new = sum(rows[tag]["new"]) / 2
        rows[tag].update(instr_per_point=instr, issue_bound_ms=issue_ms,
                         mufu_bound_ms=mufu_ms)
        log(f"sass estimate {tag}: {fmas} FFMA issued + {n_act} activations"
            f" per point, {per_fma:.3f} instructions per FFMA in the dense "
            f"loop and {per_act:.2f} per activation: {instr:.0f} instructions "
            f"per point in the dense loops and activations; issue-bound "
            f"{issue_ms * 1e3:.2f} us ({100 * issue_ms / mean_new:.0f}% of "
            f"the time), MUFU-bound {mufu_ms * 1e3:.2f} us, FMA bound "
            f"{rows[tag]['bound_ms'] * 1e3:.2f} us at n={n}")
    print(json.dumps({"mlp_turns": rows}), flush=True)


def main():
    name, smi = phase_device()
    phase_build()
    sync()
    if sys.argv[1:] == ["--profile"]:
        profile_steps()
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--mlp-turns"]:
        mlp_turns(sys.argv[2])
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
    main_taylor = taylor[0][1]          # README shapes: n = 100
    main_mlp = mlp["readme_n10000"][1]  # README predict: 10,000 points
    shapes = {"readme_n1000": taylor[1][1],
              "wide": taylor[2][1],     # 64-wide chain, n = 65,537
              "wide_n262144": taylor[3][1],
              "wide_heat": taylor[4][1],
              **{key: times for key, (_, times) in tut_taylor.items()}}
    mlp_shapes = {key: times for key, (_, times)
                  in list(mlp.items())[1:] + list(tut_mlp.items())}

    def shape_times(key, table):
        return {f"{tag}_{kind}ms": times[key + suffix]
                for tag, times in table.items()
                for kind, suffix in (("", ""), ("plain_", "_plain"),
                                     ("bound_", "_bound"))}

    def entry(name, src, replaces, times, key, err, table):
        # No single PyTorch call computes a Taylor traversal or a layout
        # chain with its skip stack: library_ms is null.
        return {"name": name, "route": "cuda",
                "source": f"pydens_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": times[key],
                "plain_ms": times[f"{key}_plain"],
                "bound_ms": times[f"{key}_bound"],
                "bound_by": times[f"{key}_bound_by"], "library_ms": None,
                **shape_times(key, table),
                "path_launches": path_launches[name]}

    kernels = [
        entry("fused_taylor_forward", "fused_taylor.cu",
              "pydens_tpu/ops/pallas_taylor.py:386", main_taylor, "fwd",
              fwd_err, shapes),
        entry("fused_taylor_backward", "fused_taylor.cu",
              "pydens_tpu/ops/pallas_taylor.py:428", main_taylor, "bwd",
              bwd_err, shapes),
        entry("fused_mlp_forward", "fused_mlp.cu",
              "pydens_tpu/ops/pallas_mlp.py:92", main_mlp, "fwd",
              max(e for e, _ in list(mlp.values()) + list(tut_mlp.values())),
              mlp_shapes),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
