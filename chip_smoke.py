"""Smoke run of pydens_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # per-step profile of w1-w5 only
    python3 chip_smoke.py --mlp-turns OLD.cu   # MLP kernel: OLD.cu vs this
    python3 chip_smoke.py --jvp-turns OLD.cu   # tangent kernel: OLD.cu vs this
    python3 chip_smoke.py --finishers  # phases 1, 2 and 9 only
    python3 chip_smoke.py --collocation   # phases 1, 2 and 10 only
    python3 chip_smoke.py --w3-repeat  # w3's eager fit, repeated

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

7. graph vs eager: ``w1`` (500 of its 1500 steps), ``w3`` (300 of its
   1000) and the wide fit, guard on, each fit once through its captured
   CUDA graphs (the package's path) and once eagerly
   (``Solver._capture_steps = False``), in turns (graph, eager, eager,
   graph): iterations/s, host ms and device busy ms per step
   (``torch.profiler`` over a replayed window, which also counts both Taylor
   kernels once per step), ``torch.cuda.max_memory_allocated``, and the
   per-step losses of the two held together (bitwise equality reported);
   the guard's ``stopped_on_nan`` index and the ``until_loss`` index of a
   ``w5`` fit on a fixed batch are the same in both;
8. the loop features on the card: a ``w1`` fit with a cosine-decay
   schedule, a callback that stops at the second chunk, ``save`` after a
   fit and ``load`` into a fresh Solver whose next fit equals the saving
   one's, ``w5`` with SGD (momentum 0.9) and with AdamW, and a
   ``profile_dir`` trace, all through graphs;
9. the finishers (``phase_finishers``): the README optimizer ladder of
   ``BENCHMARKS.md:843-852`` (Adam, then L-BFGS and Levenberg-Marquardt on
   1,024 fixed points), the ODE finishers of ``tests/test_lbfgs.py`` and
   ``tests/test_gauss_newton.py`` with their bounds, and a timing arm on
   the 64-wide chain at batch 65,536, through graphs; the step tallies
   and ``torch.profiler`` over replayed steps show every linesearch trial
   and every CG iteration launching the Taylor kernels (the tangent
   kernel in each CG iteration); LM on the 128-wide chain at 65,536; the
   LM step's device busy share and the tangent kernel's share of a CG
   iteration (``torch.profiler`` over a replayed step: the README ladder,
   the 64- and 128-wide arms); the two L-BFGS graph designs (the host
   reading the linesearch's flag between a step graph and a trial graph,
   or every trial masked in one graph) timed in turns;
10. the collocation features (``phase_collocation``) through the public
   Solver at their sources' widths, steps and batches: adaptive
   (``examples/09``) against uniform fits (the example's adaptive < 0.6 x
   uniform, on the medians over the seeds) and RBA (BENCHMARKS.md:722-745)
   against the fixed batch alone, on seeds 0-5; causal ``w3`` at eps 0
   (equal to the plain fit) and eps 5 (its plain MSE in ``w3``'s band),
   then eps 20 on the cached graph (no capture); grad balancing on the raw
   beam of ``tests/test_loss_balancing.py`` (order 4: the plain
   traversal) against unbalanced fits; NTK and grad balancing on
   ``examples/31``'s Helmholtz equation; Deep Ritz (``examples/23``)
   against the strong form.  Each arm holds its accuracy bound and its
   Taylor launches on every step of each kind, and ``torch.profiler`` over
   replays of each new step kind's graph gives its launches, device ops
   and busy ms per step.

Every fit of phases 4-8 runs the package's path: on the card a fit step
is captured as a CUDA graph once per configuration and replayed.  A
kernel wrapper counts one launch per eager step and one per capture, so
each phase asserts, from the fit steps' own tallies, that every step ran
once (eagerly or as a replay) and that each capture recorded both Taylor
kernels once; ``torch.profiler`` over a replayed window counts the kernels
on the device.

Phase 3 also checks every tutorial's Taylor chain at the batches of its
fits and the MLP kernel at the points of its predict calls
(``TUTORIAL_CHAINS``), each of phase 10's Taylor chains at the point
counts its fits, candidate pools and ``Solver.residual`` give it and the
MLP kernel at the points of phase 10's predicts (``COLLOCATION_CHAINS``;
phase 10 asserts that each solver's chain is the one checked), the MLP
kernel at ``w3``'s layout on 1,024 points, and the tangent kernel
(``taylor_jvp_kernel``, Levenberg-Marquardt's J v) on the README chain at 1,024 points, the 64-wide chain
and its 6-stream closure at 65,537, the ODE finisher's chain and the
128-wide chain at 65,537 (each with its points a tile, blocks per SM and
shared memory a block).

Prints one JSON line of per-kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

``--profile`` runs phases 1 and 2, then ``profile_steps``: one JSON line per
workload and guard setting, fits through graphs (host ms per step, device
ops and device busy ms per step), and the card's name and power limit.

``--w3-repeat`` runs phases 1 and 2, then ``w3_repeat``: ``w3``'s eager
fit twice under deterministic algorithms (naming the ops that have none)
and twice without, each pair compared bit for bit.

``--mlp-turns OLD.cu`` runs phases 1 and 2, then ``mlp_turns``: the fused
MLP kernel of an earlier ``csrc/fused_mlp.cu`` (the one-thread-per-point
design, whose C entry and op table it knows) built from ``OLD.cu`` into
``build/mlp_turns/``, timed in turns with this tree's kernel, and this
tree's kernel's SASS instruction counts (``cuobjdump``).  To take the
earlier source from git: ``git show <commit>:pydens_tpu_torch/csrc/fused_mlp.cu
> build/fused_mlp_old.cu``.

``--jvp-turns OLD.cu`` runs phases 1 and 2, then ``jvp_turns``: the
tangent kernel of an earlier ``csrc/fused_taylor.cu`` (commit 6444749:
its C entry and its launch, the weights twice and four 16-point states a
block) built from ``OLD.cu`` into ``build/jvp_turns/``, timed in turns
with this tree's at that commit's four phase-3 shapes, both held to the
plain twin.  To take the
source from git: ``git show 6444749:pydens_tpu_torch/csrc/fused_taylor.cu
> build/fused_taylor_old.cu``.

Bounds: the least time the card could take for a kernel's work, the larger
of its FMAs (2 FLOPs each) over the H100 SXM's 67 TFLOP/s f32 peak and its
bytes (each input read once, each output written once) over 3.35 TB/s; the
Taylor forward counts the products of all its streams, the backward twice
that (its recompute is the kernel's own choice and not counted), the
tangent kernel three times that.
"""

import contextlib
import gc
import json
import math
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
# The tangent kernel's shapes in phase 3 (the first four are those of commit
# 6444749, timed again by --jvp-turns).
JVP_SHAPES = {
    "readme_n1024": dict(features=[10, 12, 15, 1], n=1024, reps=200),
    "wide": dict(features=[64, 64, 64, 1], n=65537, reps=10),
    "wide_heat": dict(features=[64, 64, 64, 1], n=65537, reps=10,
                      closure=HEAT_CLOSURE, in_dim=3),
    "ode_n512": dict(features=[12, 10, 1], n=512, reps=200, closure=[(0,)],
                     in_dim=1, layout="fafaf"),
    "wide128": dict(features=[128, 128, 1], n=65537, reps=10,
                    layout="fa fa f"),
}
WIDE128 = dict(ndims=2, boundary_condition=1, layout="fa fa f",
               activation="Tanh", units=[128, 128, 1])
F32_FLOPS = 67e12           # H100 SXM f32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
# Each tutorial's Taylor chain (network and closure of its equation), the
# batch sizes of its fits, and the points of its predict calls in phase 6.
# w3's fit (benchmarks/bench_loss_parity.py), with its sampler.
W3_FIT = dict(niters=1000, batch_size=1500, lr=0.001)
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


_T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
    weights in, the streams out), backward (twice the products; x, the
    weights and the cotangent in, dW and dx out) and tangent (three times
    the products: the primal, tangent x W and state x tangent W; x, the
    weights and their tangent in, the streams and their tangent out)."""
    fmas = n * plan.n_streams * _products(plan.ops)
    streams = n * plan.n_streams * plan.out_dim
    fwd_bytes = 4 * (n * plan.in_dim + plan.n_params + streams)
    bwd_bytes = fwd_bytes + 4 * (plan.n_params + n * plan.in_dim)
    jvp_bytes = fwd_bytes + 4 * (plan.n_params + streams)
    return {"fwd": bound(fmas, fwd_bytes), "bwd": bound(2 * fmas, bwd_bytes),
            "jvp": bound(3 * fmas, jvp_bytes)}


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


def check_taylor_jvp(features, n, reps, seed=0, closure=POISSON_CLOSURE,
                     in_dim=2, layout="fa fa fa f", act="Tanh"):
    """The tangent kernel against its plain twin (``torch.func.jvp`` of the
    plain forward) at VALUE_TOL, streams and tangent, for a seeded tangent
    of the weights; both timed in turns, with the kernel's bound."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, packed, x = _taylor_case(layout, features, act, n, seed, closure,
                                   in_dim)
    v = torch.randn(plan.n_params, device=x.device,
                    generator=torch.Generator(x.device).manual_seed(seed + 1))
    out, tout = ft.fused_taylor_jvp(packed, x, v, plan)
    ref, tref = ft.fused_taylor_jvp_plain(packed, x, v, plan)
    sync()
    torch.testing.assert_close(out, ref, **VALUE_TOL)
    torch.testing.assert_close(tout, tref, **VALUE_TOL)
    err = max(max_err(out, ref), max_err(tout, tref))
    times = timed_pair("jvp", lambda: ft.fused_taylor_jvp(packed, x, v, plan),
                       lambda: ft.fused_taylor_jvp_plain(packed, x, v, plan),
                       reps)
    b, by, work = taylor_bounds(plan, n)["jvp"]
    # Blocks per SM from the CUDA occupancy calculator (registers and shared
    # memory), at least what the plan sized the block for.
    per_sm = ft.jvp_blocks_per_sm(plan, x.device)
    assert per_sm >= plan.jvp_blocks_per_sm, (per_sm, plan.jvp_blocks_per_sm)
    grid, slots = plan.jvp_launch_shape(
        n, torch.cuda.get_device_properties(0).multi_processor_count, per_sm)
    log(f"taylor jvp {layout!r} {act} {features} in_dim {in_dim} closure "
        f"{len(closure)} n={n}: max|err| {err:.3e} (streams and tangent; "
        f"{100 * max(_tol_used(out, ref), _tol_used(tout, tref)):.1f}% of "
        f"VALUE_TOL), jvp {times['jvp']:.4f} ms (plain "
        f"{times['jvp_plain']:.4f} ms); {work}, {_share(times['jvp'], b)} "
        f"({by}); {plan.jvp_tile} points a tile, weights "
        f"{'resident' if plan.jvp_resident else 'streamed'}, {grid} blocks "
        f"of {slots} slots, {per_sm} blocks per SM on the card (occupancy "
        f"calculator; the plan sized for {plan.jvp_blocks_per_sm}), "
        f"{plan.jvp_smem} B shared memory each")
    times.update(jvp_tile=plan.jvp_tile, jvp_resident=plan.jvp_resident,
                 jvp_blocks_per_sm=per_sm, jvp_smem_bytes=plan.jvp_smem)
    times["jvp_bound"], times["jvp_bound_by"] = b, by
    return err, times


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
    # Phase 10's shapes, keyed "<chain>_n<points>".
    tut_taylor.update({f"{c}_n{n}": check_taylor(n=n, reps=200, **chain)
                       for c, (chain, counts, _)
                       in COLLOCATION_CHAINS.items() for n in counts})
    # The tangent kernel (Levenberg-Marquardt's J v): the README chain at
    # the finishers' 1,024 points, the 64-wide chain and the 6-stream
    # closure, the ODE finisher's chain, and the 128-wide chain of phase
    # 9's LM arm; "readme_n1024" heads the JSON line.
    jvp = {tag: check_taylor_jvp(**case) for tag, case in JVP_SHAPES.items()}
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
    tut_mlp.update({f"{c}_n{n}": check_mlp(chain["layout"], chain["features"],
                                           chain["in_dim"], n, reps=200,
                                           act=chain["act"])
                    for c, (chain, _, predicts) in COLLOCATION_CHAINS.items()
                    for n in predicts})
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
    return taylor, tut_taylor, mlp, tut_mlp, jvp


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


TAYLOR_KERNELS = ("taylor_fwd_kernel", "taylor_bwd_kernel")


def fit_tally(solver):
    """``(eager steps, replays, captured graphs)`` over the solver's cached
    fit steps."""
    steps = list(solver._step_cache.values())
    return (sum(s.eager_steps for s in steps), sum(s.replays for s in steps),
            sum(s.graph is not None for s in steps))


def assert_taylor_every_step(solver, steps, launches):
    """Each of the solver's ``steps`` steps ran once on the card, eagerly or
    as a replay of a captured graph, and each eager step and each capture
    launched both Taylor kernels once (the wrappers count both), so both
    ran on every step.  Returns the kernels' launches on the device (eager
    steps plus replays) and the tally."""
    eager, replays, graphs = fit_tally(solver)
    assert eager + replays == steps, (eager, replays, steps)
    assert replays > 0 and graphs > 0, (eager, replays, graphs)
    for name in ("fused_taylor_forward", "fused_taylor_backward"):
        assert launches[name] == eager + graphs, (name, launches, eager,
                                                  graphs)
    return eager + replays, dict(eager=eager, replays=replays, graphs=graphs)


def step_profile(solver, fit, steps=50, windows=3):
    """The steady step of ``fit`` (its kwargs) in chunks of ``steps``: a
    first fit of that configuration warms it up (on the card: its eager
    step and its capture) outside both windows; then host ms per step (host
    clock over ``steps`` steps ending in a synchronize) and, from
    ``torch.profiler`` over ``steps`` more, device ops and busy ms per step
    (kernels, copies and fills) and each Taylor kernel's launches per step
    on the device.  The profiler records a fit of its own before the
    measured one and drops it (its ``warmup``): without it, the first
    records of a window were lost (the 64-wide fit: 18 of 26,626, one of
    them a forward kernel).  A window whose Taylor kernel counts are not
    one per step is taken again, up to ``windows`` times
    (``windows_taken``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fit = dict(fit, niters=steps, chunk_size=steps, progress=False)
    solver.fit(**fit)
    sync()
    t0 = time.perf_counter()
    solver.fit(**fit)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    for taken in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                solver.fit(**fit)
                sync()
                prof.step()
        # Under a schedule the step's own annotation shows as a device
        # record spanning the step: not device work.
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
        counts = {k: sum(k in e.name for e in dev) for k in TAYLOR_KERNELS}
        if all(c == steps for c in counts.values()):
            break
        log(f"profiler window {taken}: {len(dev)} device records, Taylor "
            f"kernels {counts} in {steps} steps; taking another")
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    row = dict(step_ms=step_ms, device_busy_ms=busy_ms,
               busy_share=busy_ms / step_ms, device_ops=len(dev) / steps,
               windows_taken=taken)
    for k in TAYLOR_KERNELS:
        row[f"{k}_per_step"] = counts[k] / steps
    return row


def assert_profiled_taylor(row, tag):
    per_step = [row[f"{k}_per_step"] for k in TAYLOR_KERNELS]
    assert per_step == [1.0, 1.0], (tag, row)


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
    device_launches, tally = assert_taylor_every_step(solver, 1500, launches)
    log(f"poisson fit (kernels, CUDA graphs): {wall:.3f} s, {rate:.1f} it/s, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.6f}; wrapper launches "
        f"{launches}; steps {tally}: each Taylor kernel launched "
        f"{device_launches} times on the card")
    assert losses.shape == (1500,) and np.isfinite(losses).all()
    assert losses[-1] < 0.01, losses[-1]
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
    prof = step_profile(solver, dict(batch_size=100))
    assert_profiled_taylor(prof, "w1")
    log(f"poisson steady step (graph replays, 50 steps): {json.dumps(prof)}")

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
    log(f"poisson fit (plain path, CUDA graphs): {p_wall:.3f} s, "
        f"{p_rate:.1f} it/s, loss {p_losses[0]:.5f} -> {p_losses[-1]:.6f}")
    sync()
    return launches, device_launches, prof


def _falling(losses):
    k = max(1, len(losses) // 10)
    return (np.isfinite(losses).all()
            and losses[-k:].mean() < losses[:k].mean())


def free_card():
    """Drop what the last solver left: its fit steps hold CUDA graphs and
    their pools, and their closures reach back to the solver (a cycle)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_wide_fit():
    """The 64-wide Poisson fit in four arms: kernels; kernels with
    ``stop_on_nan=False`` (the guard's cost, in turns with the first arm:
    kernels, off, off, kernels); the Taylor traversal on its plain version;
    nested gradients (``fast_taps=False``).  Each arm runs WIDE_STEPS
    steps (its eager warm-up step and its capture included), then
    WIDE_STEPS timed steps, which replay that graph."""
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
        for c in counters:
            c.launches = 0
        sync()
        t0 = time.perf_counter()
        solver.fit(niters=WIDE_STEPS, **kw)
        sync()
        first = time.perf_counter() - t0
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
            f"points/s, loss {losses[0]:.5f} -> {losses[-1]:.5f} (the first "
            f"{WIDE_STEPS}, with the warm-up step and the capture, "
            f"{first:.3f} s); wrapper launches {launches}, steps "
            f"{fit_tally(solver)}")
        assert losses.shape == (WIDE_STEPS,) and _falling(losses), arm
        if arm in ("kernels", "unguarded"):
            assert_taylor_every_step(solver, 2 * WIDE_STEPS, launches)
        else:
            assert max(launches.values()) == 0, launches
        del solver
        free_card()
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
            (None, dict(W3_FIT, sampler=sampler))]
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
    before it and read just after its predict; then a replayed window of
    its last fit under the profiler."""
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
        device_launches, tally = assert_taylor_every_step(solver, steps,
                                                          launches)
        log(f"tutorial {name}: {steps} steps in {wall:.3f} s, "
            f"{steps / wall:.1f} it/s, loss {losses[0]:.5f} -> "
            f"{losses[-1]:.6f}, metric {metric:.6f} (band "
            f"{TUTORIAL_BANDS[name]}); wrapper launches {launches}; steps "
            f"{tally}: each Taylor kernel launched {device_launches} times "
            "on the card")
        assert losses.shape == (steps,) and _falling(losses), name
        assert launches["fused_mlp_forward"] >= 1, launches
        assert metric < TUTORIAL_BANDS[name], (name, metric)
        results[name] = (launches, device_launches)
        prof = step_profile(solver, _tutorial(name)[2][-1][1])
        assert_profiled_taylor(prof, name)
        log(f"tutorial {name} steady step (graph replays, 50 steps): "
            f"{json.dumps(prof)}")
        if name == "w3":   # (x, y) at t = 0.25, a = 1
            dense_predict(solver, _grid(0.25, 1.0), "w3")
        del solver
        free_card()
    return results


# Phase 7's depth: the eager fits of w1 and w3 are cut to these steps (of
# 1500 and 1000) to keep the run's time for the later phases.
GVE_STEPS = {"w1": 500, "w3": 300}


def _gve_workload(name):
    """``(equation, Solver kwargs, fits)`` of a graph-vs-eager workload."""
    if name == "wide":
        return _pde(), dict(WIDE), [
            (None, dict(niters=WIDE_STEPS, batch_size=WIDE_BATCH))]
    eq, kw, fits = _tutorial(name)
    return eq, kw, [(hook, dict(fit, niters=GVE_STEPS[name]))
                    for hook, fit in fits]


class _FixedPoints:
    """Host-protocol sampler returning seeded fixed points (no device
    path): the same batch for the graph and the eager fit."""

    def __init__(self, n, total, seed=0):
        self.pts = np.random.default_rng(seed).uniform(
            size=(n, total)).astype(np.float32)

    def sample(self, size):
        return self.pts[:size]


def _stop_indices():
    """The guard's ``stopped_on_nan`` index (``w5`` at lr 30 on a fixed
    batch) and the ``until_loss`` index (``w5`` at lr 0.05, tol in the
    widest gap between a loss and the lowest before it, from the eager
    run), each through graphs and eagerly."""
    import warnings
    from pydens_tpu_torch import Solver
    eq, kw, _ = _tutorial("w5")
    sampler = _FixedPoints(64, 1)

    def run(capture, **fit):
        solver = Solver(eq, seed=0, device="cuda", **kw)
        solver._capture_steps = capture
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solver.fit(batch_size=64, sampler=sampler, resample=False,
                       progress=False, **fit)
        return solver

    nan = {c: run(c, niters=30, lr=30.0, chunk_size=10).history[-1].get(
        "stopped_on_nan") for c in (True, False)}
    probe = np.asarray(run(False, niters=60, lr=0.05, chunk_size=7).losses)
    run_min = np.minimum.accumulate(probe)
    gaps = run_min[:-1] / probe[1:]
    k = 5 + int(np.argmax(gaps[5:])) + 1
    tol = float(np.sqrt(run_min[k - 1] * probe[k]))
    conv = {c: run(c, niters=60, lr=0.05, chunk_size=7,
                   until_loss=tol).history[-1].get("converged_at")
            for c in (True, False)}
    log(f"guard under graphs: stopped_on_nan graph {nan[True]}, eager "
        f"{nan[False]}; until_loss={tol:.6g}: converged_at graph "
        f"{conv[True]}, eager {conv[False]} (expected {k})")
    assert nan[True] is not None and nan[True] == nan[False]
    assert conv[True] == conv[False] == k
    free_card()
    return dict(stopped_on_nan=nan[True], converged_at=conv[True])


def phase_graph_vs_eager():
    """``w1``, ``w3`` and the wide fit, guard on, through graphs and eagerly
    in turns (graph, eager, eager, graph), each on a fresh solver of seed 0:
    the whole fit's iterations/s (graph: its warm-up step and capture
    included) and peak device memory, the steady step (``step_profile``),
    and the per-step losses of the first graph and first eager fit held
    together (rtol 1e-5 over the first 20 steps and 1e-3 at the end, the
    tolerance of tests/test_torch_graphs_gpu.py; bitwise equality
    reported)."""
    from pydens_tpu_torch import Solver
    rows = {}
    for name in ("w1", "w3", "wide"):
        runs = {True: [], False: []}
        for capture in (True, False, False, True):
            eq, kw, fits = _gve_workload(name)
            free_card()
            sync()
            torch.cuda.reset_peak_memory_stats()
            solver = Solver(eq, seed=0, device="cuda", **kw)
            solver._capture_steps = capture
            steps = sum(fit["niters"] for _, fit in fits)
            sync()
            t0 = time.perf_counter()
            for hook, fit in fits:
                if hook is not None:
                    hook(solver.model)
                solver.fit(progress=False, **fit)
            sync()
            wall = time.perf_counter() - t0
            mem = torch.cuda.max_memory_allocated()
            losses = np.asarray(solver.losses[:steps])
            tally = fit_tally(solver)
            assert (tally[1] > 0) == capture, (capture, tally)
            # Eager windows of 20 steps: a 50-step eager window of w3 (54k
            # device records) lost a Taylor record in three windows running.
            prof = step_profile(solver, fits[-1][1],
                                steps=50 if capture else 20, windows=5)
            assert_profiled_taylor(prof, f"{name} capture={capture}")
            runs[capture].append(dict(it_s=steps / wall, peak_mib=mem / 2**20,
                                      losses=losses, **prof))
            log(f"{name} {'graph' if capture else 'eager'}: {steps} steps "
                f"{steps / wall:.1f} it/s, peak memory {mem / 2**20:.1f} "
                f"MiB, steps {tally}; steady {json.dumps(prof)}")
            del solver
        g, e = runs[True][0]["losses"], runs[False][0]["losses"]
        assert g.shape == e.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g[:20], e[:20], rtol=1e-5)
        np.testing.assert_allclose(g[-1], e[-1], rtol=1e-3)
        same = {arm: np.array_equal(runs[c][0]["losses"],
                                    runs[c][1]["losses"])
                for c, arm in ((True, "graph"), (False, "eager"))}
        rel = float(np.max(np.abs(g - e) / np.abs(e)))
        row = {"bitwise_equal": bool(np.array_equal(g, e)),
               "graph_repeat_bitwise": same["graph"],
               "eager_repeat_bitwise": same["eager"], "max_rel_diff": rel}
        for capture, arm in ((True, "graph"), (False, "eager")):
            for key in ("it_s", "peak_mib", "step_ms", "device_busy_ms",
                        "busy_share", "device_ops"):
                row[f"{arm}_{key}"] = [r[key] for r in runs[capture]]
        row["graph_taylor_launches_per_step"] = runs[True][0][
            "taylor_fwd_kernel_per_step"]
        rows[name] = row
        log(f"graph vs eager {name}: {json.dumps(row)}")
    rows["stops"] = _stop_indices()
    return rows


def _w5_fits(solver, **opt):
    """w5's two phases with the optimizer ``opt`` (kwargs of fit)."""
    eq_fits = _tutorial("w5")[2]
    for hook, fit in eq_fits:
        hook(solver.model)
        solver.fit(progress=False, **dict(fit, **opt))
    return sum(fit["niters"] for _, fit in eq_fits)


def phase_loop_features():
    """The loop features through graphs on the card: a cosine-decay
    schedule, a callback stop, save / load / resume, SGD and AdamW on
    ``w5``, and a ``profile_dir`` trace."""
    import os
    from pathlib import Path
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.utils.schedules import cosine_decay_schedule
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    results = {}

    s = Solver(_pde(), seed=0, **README)
    wall, rate = timed_fit(s, lr=cosine_decay_schedule(0.005, 1500))
    losses = np.asarray(s.losses)
    assert fit_tally(s) == (1, len(losses) - 1, 1) and _falling(losses)
    results["cosine_final_loss"] = float(losses[-1])
    log(f"w1 with cosine_decay_schedule(0.005, 1500): {rate:.1f} it/s, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.6f}, steps {fit_tally(s)}")

    seen = []
    s = Solver(_pde(), seed=0, **README)
    s.fit(niters=1500, batch_size=100, chunk_size=100, progress=False,
          callback=lambda it, chunk: seen.append((it, len(chunk))) or it >= 200)
    assert seen == [(100, 100), (200, 100)] and len(s.losses) == 200
    log(f"callback stop at the second chunk: calls {seen}, "
        f"{len(s.losses)} losses, steps {fit_tally(s)}")

    path = str(out / "w1.npz")
    a = Solver(_pde(), seed=0, **README)
    a.fit(niters=500, batch_size=100, progress=False)
    a.save(path)
    a.fit(niters=500, batch_size=100, progress=False, optimizer=None)
    b = Solver(_pde(), seed=1, **README)
    b.load(path)
    b.fit(niters=500, batch_size=100, progress=False)
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-6)
    results["resume_bitwise"] = a.losses == b.losses
    log(f"save / load / resume: the loaded solver's next 500 losses equal "
        f"the saver's (bitwise: {results['resume_bitwise']}), final "
        f"{b.losses[-1]:.6f}")

    for tag, opt in (("sgd", dict(optimizer="SGD", momentum=0.9)),
                     ("adamw", dict(optimizer="AdamW"))):
        s = Solver(_tutorial("w5")[0], seed=0, **_tutorial("w5")[1])
        sync()
        t0 = time.perf_counter()
        steps = _w5_fits(s, **opt)
        sync()
        wall = time.perf_counter() - t0
        metric = tutorial_metric("w5", s)
        losses = np.asarray(s.losses)
        eager, replays, graphs = fit_tally(s)
        assert eager + replays == steps and graphs == 2 and _falling(losses)
        results[f"w5_{tag}_metric"] = metric
        log(f"w5 with {opt}: {steps / wall:.1f} it/s, loss {losses[0]:.5f} "
            f"-> {losses[-1]:.6f}, |new_var - 2| {metric:.6f} (band "
            f"{TUTORIAL_BANDS['w5']}), steps {fit_tally(s)}")

    trace_dir = out / "profile"
    s = Solver(_pde(), seed=0, **README)
    s.fit(niters=100, batch_size=100, progress=False, profile_dir=trace_dir)
    traces = sorted(os.listdir(trace_dir))
    text = (trace_dir / traces[-1]).read_text()
    assert "taylor_fwd_kernel" in text, traces
    log(f"profile_dir: {traces[-1]} ({len(text)} bytes) holds the Taylor "
        "kernels")
    del s, a, b
    free_card()
    return results


# Phase 9: the second-order finishers.  The ODE finisher of
# tests/test_lbfgs.py and tests/test_gauss_newton.py, with its bounds.
ODE = dict(ndims=1, initial_condition=.5, activation="Tanh", layout="fafaf",
           features=[12, 10, 1])
ODE_SEEDS = (0, 1, 2, 3, 4)


def _ode():
    from pydens_tpu_torch import D

    def ode(f, x):
        return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
    return ode


def _finisher_counters():
    from pydens_tpu_torch.ops import fused_taylor as ft
    return (ft.fused_taylor_forward, ft.fused_taylor_backward,
            ft.fused_taylor_jvp)


def _finisher_step(solver):
    """The cached fit step of the solver's current optimizer."""
    return [s for s in solver._step_cache.values() if s.opt is solver._opt][-1]


def _finisher_tally(step):
    return dict(eager=step.eager_steps, replays=step.replays,
                eager_trials=getattr(step, "eager_trials", 0),
                trial_replays=getattr(step, "trial_replays", 0),
                graph=int(step.graph is not None),
                trial_graph=int(getattr(step, "trial_graph", None)
                                is not None),
                live=int(step.live))


def _evals(step):
    """Taylor forward / backward / tangent launches of one eager step or
    one capture of ``step``'s step graph, by the step's design: an LM step
    evaluates the residual twice (at theta and at the trial), runs the
    backward once for J^T r and once in each CG iteration, and the tangent
    kernel in each CG iteration; an L-BFGS step evaluates loss and gradient
    at theta and at its first trial (masked: at every trial it may
    take)."""
    if hasattr(step.opt, "cg_iters"):
        cg = step.opt.cg_iters
        return (2, cg + 1, cg)
    n = 1 + (step.opt.linesearch.max_linesearch_steps if step.masked else 1)
    return (n, n, 0)


def run_finisher(solver, optimizer, niters, batch, tag, **kw):
    """One finisher fit through graphs on a fixed batch (``resample=False``:
    one draw of the default sampler), checked by its tallies: every step
    ran once (eagerly or replayed), each eager step and each capture
    launched the Taylor kernels as the step's design says, and the live
    trials (L-BFGS) agree with the host's count of trial replays.  Returns
    the row: it/s over the whole fit (host clock ending in a synchronize;
    the configuration's warm-up and capture included on its first fit),
    linesearch trials or live CG iterations per step, and the Taylor
    launches per step on the card."""
    counters = _finisher_counters()
    snap = {id(s): _finisher_tally(s) for s in solver._step_cache.values()}
    before_counts = [c.launches for c in counters]
    sync()
    t0 = time.perf_counter()
    solver.fit(niters=niters, batch_size=batch, optimizer=optimizer,
               resample=False, progress=False, **kw)
    sync()
    wall = time.perf_counter() - t0
    step = _finisher_step(solver)
    lm = hasattr(step.opt, "cg_iters")
    after = _finisher_tally(step)
    before = snap.get(id(step), dict.fromkeys(after, 0))
    d = {k: after[k] - before[k] for k in after}
    launches = [c.launches - b for c, b in zip(counters, before_counts)]
    steps = d["eager"] + d["replays"]
    assert steps == niters, (tag, d)
    per_eval = _evals(step)
    trials = d["live"]
    if lm or step.masked:
        # The graph holds the whole step.
        wrapper = [(d["eager"] + d["graph"]) * k for k in per_eval]
        device = [steps * k for k in per_eval]
    else:
        # A step graph (theta and the first trial) and a trial graph.
        assert trials == (d["eager"] + d["eager_trials"] + d["replays"]
                          + d["trial_replays"]), (tag, d)
        evals = 2 * d["eager"] + d["eager_trials"]
        wrapper = [evals + 2 * d["graph"] + d["trial_graph"]] * 2 + [0]
        device = [evals + 2 * d["replays"] + d["trial_replays"]] * 2 + [0]
        assert device[0] == steps + trials, (tag, d)
    assert launches == wrapper, (tag, launches, wrapper, d)
    losses = np.asarray(solver.losses[-niters:])
    assert np.isfinite(losses).all(), tag
    row = dict(it_s=niters / wall, steps=niters, final_loss=float(losses[-1]),
               first_loss=float(losses[0]),
               per_step=("live_cg_iterations" if lm
                         else "linesearch_trials"),
               per_step_mean=trials / steps,
               taylor_fwd_per_step=device[0] / steps,
               taylor_bwd_per_step=device[1] / steps,
               taylor_jvp_per_step=device[2] / steps,
               wrapper_launches=launches, tally=d)
    log(f"finisher {tag} ({optimizer or 'reused'}): {niters} steps at batch "
        f"{batch} in {wall:.3f} s, {row['it_s']:.2f} it/s, loss "
        f"{losses[0]:.4e} -> {losses[-1]:.4e}; {row['per_step']} per step "
        f"{row['per_step_mean']:.2f}; Taylor launches per step on the card "
        f"fwd {row['taylor_fwd_per_step']:.2f} bwd "
        f"{row['taylor_bwd_per_step']:.2f} jvp "
        f"{row['taylor_jvp_per_step']:.2f}; tally {d}")
    return row


def finisher_profile(solver, batch, steps, tag, windows=3):
    """``torch.profiler`` over a window of ``steps`` replayed steps of the
    solver's finisher (after two unprofiled fits of that configuration, two
    timed ones and a profiled warm-up fit, as ``step_profile``): each Taylor
    kernel's device records, against what the live trials (L-BFGS: one
    forward and one backward at theta and at each trial) or the CG loop
    (LM: two forwards, ``cg_iters + 1`` backwards and ``cg_iters`` tangents
    a step) say every step launched.  Returns the counts per step, host ms
    per step (each timed fit of ``steps`` steps: a fit's fixed host cost is
    spread over its steps, so take several) and their mean, device busy ms
    per step (summed device records) and the busy share against each timed
    fit, each Taylor kernel's device ms per step and, for LM, per CG
    iteration: the step's busy ms and the tangent kernel's ms over
    ``cg_iters`` (a step is its CG iterations plus two residuals, one J^T r
    and the update) and the tangent's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = ("taylor_fwd_kernel", "taylor_bwd_kernel", "taylor_jvp_kernel")
    fit = dict(niters=steps, batch_size=batch, optimizer=None,
               resample=False, progress=False)
    # Two fits: the configuration's eager step and its capture (a 1-step
    # fit takes one of them), so the timed fit replays.
    solver.fit(**fit)
    solver.fit(**fit)
    step = _finisher_step(solver)
    lm = hasattr(step.opt, "cg_iters")
    timed = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        solver.fit(**fit)
        sync()
        timed.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sum(timed) / len(timed)
    for taken in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for i in range(2):
                live = int(step.live)
                solver.fit(**fit)
                sync()
                live = int(step.live) - live
                prof.step()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
        counts = [sum(k in e.name for e in dev) for k in names]
        expect = ([k * steps for k in _evals(step)] if lm
                  else [steps + live, steps + live, 0])
        if counts == expect:
            break
        log(f"finisher profile {tag} window {taken}: {counts} Taylor "
            f"records, expected {expect}; taking another")
    assert counts == expect, (tag, counts, expect)
    row = {f"{k}_per_step": c / steps for k, c in zip(names, counts)}
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    row.update(windows_taken=taken, device_ops_per_step=len(dev) / steps,
               live_per_step=live / steps, steps=steps, step_ms=step_ms,
               step_ms_timed=timed, device_busy_ms=busy_ms,
               busy_share=busy_ms / step_ms,
               busy_share_timed=[busy_ms / ms for ms in timed])
    for k in names:
        row[f"{k}_ms_per_step"] = sum(e.time_range.elapsed_us() for e in dev
                                      if k in e.name) / 1e3 / steps
    if lm:
        cg = step.opt.cg_iters
        row.update(busy_ms_per_cg_iteration=busy_ms / cg,
                   jvp_ms_per_cg_iteration=(
                       row["taylor_jvp_kernel_ms_per_step"] / cg),
                   jvp_share_of_busy=(row["taylor_jvp_kernel_ms_per_step"]
                                      / busy_ms),
                   bwd_share_of_busy=(row["taylor_bwd_kernel_ms_per_step"]
                                      / busy_ms))
    log(f"finisher profile {tag} (replays, {steps} steps): {json.dumps(row)}")
    return row


def _ode_error(solver):
    xs = np.linspace(0, 1, 100, dtype=np.float32)
    return float(np.abs(solver.predict(xs).ravel()
                        - (np.sin(2 * np.pi * xs) + .5)).max())


def _design_turns(make, adam_params, batch, steps, tag):
    """The two L-BFGS graph designs in turns (host-driven, masked, masked,
    host-driven), each on a fresh solver from the same Adam parameters and
    the same fixed batch: a fit of ``steps`` steps (the warm-up and the
    captures), then a timed fit of ``steps`` more of the same
    configuration, which replays.  Returns both designs' rates."""
    from pydens_tpu_torch import Solver
    eq, kw = make
    rates = {False: [], True: []}
    trials = {}
    for masked in (False, True, True, False):
        solver = Solver(eq, seed=0, device="cuda", **kw)
        solver.model.load_params(adam_params)
        solver._masked_linesearch = masked
        run_finisher(solver, "LBFGS", steps, batch, f"{tag} warm-up")
        row = run_finisher(solver, None, steps, batch,
                           f"{tag} {'masked' if masked else 'host-driven'}")
        rates[masked].append(row["it_s"])
        trials[masked] = row["per_step_mean"]
        del solver
        free_card()
    out = {"host_driven_it_s": rates[False], "masked_it_s": rates[True],
           "trials_per_step": trials[False]}
    log(f"L-BFGS designs {tag}: host-driven {rates[False]} it/s, masked "
        f"{rates[True]} it/s (in turns), {trials[False]:.2f} trials a step")
    return out


@contextlib.contextmanager
def _plain_refused():
    """Every kernel's plain version raises while this is entered: a run
    under it shows that no ``*_plain`` function ran."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    names = [(ft, "fused_taylor_forward_plain"),
             (ft, "fused_taylor_backward_plain"),
             (ft, "fused_taylor_jvp_plain"), (fm, "fused_mlp_forward_plain")]
    saved = [getattr(mod, name) for mod, name in names]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran where the kernels must")
    try:
        for mod, name in names:
            setattr(mod, name, refuse)
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def phase_finishers():
    with _plain_refused():
        return _finishers()


def _finishers():
    """The finishers through the public Solver on the card, the launch
    counters set to 0 just before and read just after: (i) the README
    ladder of BENCHMARKS.md:843-852 (Adam 1500 at batch 100, L-BFGS 200
    and LM 50 at 1,024 fixed points): L-BFGS below Adam, LM below 1.9e-5
    (3x pydens_tpu's 6.2e-6); (ii) the ODE finishers of tests/test_lbfgs.py
    and tests/test_gauss_newton.py (Adam 300 at 512, lr 0.02, then L-BFGS
    100 or LM 40 on a fixed batch), on ODE_SEEDS: each below its Adam
    phase (LM below 1e-2 of it) and its error bound (L-BFGS 0.02, LM
    5e-3) on every seed, and below its loss bound (1e-4, 2e-6) on one;
    (iii) a timing arm on the 64-wide chain at batch 65,536 (5 L-BFGS,
    then 3 LM steps, each timed on a second fit of replays); (iv) LM on the
    128-wide chain at 65,536 (20 Adam, then 3 + 3 LM steps): the loss
    falls and every CG iteration launches the tangent kernel.  Profiler
    windows of replayed LM steps (5 on the README ladder, 3 on the 64- and
    128-wide arms, each against two timed fits as long) give the step's
    device busy share and the tangent kernel's share of a CG iteration.
    Then the two L-BFGS graph designs in turns, and profiler windows of
    the ODE finishers' replayed steps.
    Every kernel's plain version raises throughout (``_plain_refused``)."""
    from pydens_tpu_torch import Solver
    counters = _finisher_counters()
    for c in counters:
        c.launches = 0
    rows = {}

    s = Solver(_pde(), seed=0, **README)
    s.fit(niters=1500, batch_size=100, progress=False)
    adam = float(s.losses[-1])
    readme_adam = _clone_tree(s.model.params)
    rows["ladder_lbfgs"] = run_finisher(s, "LBFGS", 200, 1024, "README")
    rows["ladder_lm"] = run_finisher(s, "LM", 50, 1024, "README")
    rows["ladder"] = dict(adam=adam, lbfgs=rows["ladder_lbfgs"]["final_loss"],
                          lm=rows["ladder_lm"]["final_loss"])
    log(f"README ladder: Adam {adam:.4e}, L-BFGS {rows['ladder']['lbfgs']:.4e}"
        f", LM {rows['ladder']['lm']:.4e} (pydens_tpu on a CPU: 2.1e-3, "
        "7.0e-4, 6.2e-6)")
    assert rows["ladder"]["lbfgs"] < adam, rows["ladder"]
    assert rows["ladder"]["lm"] < 1.9e-5, rows["ladder"]
    rows["ladder_lm_profile"] = finisher_profile(s, 1024, 5, "README LM")
    del s
    free_card()

    # The ODE finishers' loss bounds are those of one seed of the JAX tests:
    # where the Adam phase ends varies by seed, and neither finisher reaches
    # its floor in its steps.  On the CPU, pydens_tpu's seeds 0, 1 and 2
    # end the L-BFGS finisher at 4.6e-5, 1.04e-4 and 1.67e-4, its seeds 0
    # and 1 the LM finisher at 8.9e-7 and 5.6e-6 (the port from the same
    # theta and points: 7.7e-7 and 5.7e-6).  So each finisher runs on
    # ODE_SEEDS and ends below its Adam phase (LM below 1e-2 of it, as the
    # JAX test asserts) and within its error bound on every seed, and
    # below its loss bound on one, as in pydens_tpu.
    for opt, niters, drop, loss_bound, err_bound in (
            ("LBFGS", 100, 1.0, 1e-4, 0.02), ("LM", 40, 1e-2, 2e-6, 5e-3)):
        seeds = {}
        for seed in ODE_SEEDS:
            s = Solver(_ode(), seed=seed, device="cuda", **ODE)
            s.fit(niters=300, batch_size=512, lr=0.02, progress=False)
            adam = float(s.losses[-1])
            row = run_finisher(s, opt, niters, 512, f"ODE {opt} seed {seed}")
            row.update(adam=adam, max_error=_ode_error(s))
            if seed == ODE_SEEDS[0]:
                row.update(finisher_profile(s, 512, 5, f"ODE {opt}"))
            seeds[seed] = row
            log(f"ODE finisher {opt}, seed {seed}: Adam {adam:.4e} -> "
                f"{row['final_loss']:.4e}, max error {row['max_error']:.4e} "
                f"(bounds {loss_bound}, {err_bound})")
            del s
            free_card()
        summary = {k: (r["adam"], r["final_loss"], r["max_error"])
                   for k, r in seeds.items()}
        assert all(loss < drop * adam and err < err_bound
                   for adam, loss, err in summary.values()), summary
        assert min(loss for _, loss, _ in summary.values()) < loss_bound, \
            summary
        rows[f"ode_{opt.lower()}"] = dict(
            seeds[ODE_SEEDS[0]],
            seeds={k: {f: r[f] for f in ("adam", "final_loss", "max_error",
                                         "it_s", "per_step_mean")}
                   for k, r in seeds.items()})

    s = Solver(_pde(), seed=0, **WIDE)
    s.fit(niters=50, batch_size=WIDE_BATCH, progress=False)
    wide_adam = _clone_tree(s.model.params)
    for opt, niters in (("LBFGS", 5), ("LM", 3)):
        run_finisher(s, opt, niters, WIDE_BATCH, f"wide {opt} first fit")
        rows[f"wide_{opt.lower()}"] = run_finisher(
            s, None, niters, WIDE_BATCH, f"wide {opt}")
    rows["wide_lm_profile"] = finisher_profile(s, WIDE_BATCH, 3, "wide LM")
    del s
    free_card()

    # The 128-wide chain, whose tangent block the first design did not fit
    # (LM raised on the plan path): 20 Adam steps, then LM on a fixed
    # batch, every CG iteration through the tangent kernel.
    s = Solver(_pde(), seed=0, **WIDE128)
    s.fit(niters=20, batch_size=WIDE_BATCH, progress=False)
    adam = float(s.losses[-1])
    first = run_finisher(s, "LM", 3, WIDE_BATCH, "wide128 LM first fit")
    row = run_finisher(s, None, 3, WIDE_BATCH, "wide128 LM")
    cg = s._opt.cg_iters
    assert first["final_loss"] < adam, (adam, first)
    assert row["final_loss"] <= first["final_loss"], (first, row)
    assert first["taylor_jvp_per_step"] == row["taylor_jvp_per_step"] == cg
    row.update(adam=adam, first_fit=first,
               profile=finisher_profile(s, WIDE_BATCH, 3, "wide128 LM"))
    rows["wide128_lm"] = row
    log(f"wide128 LM: Adam 20 {adam:.4e} -> LM {first['final_loss']:.4e} "
        f"-> {row['final_loss']:.4e}")
    del s
    free_card()
    launches = {c.__name__: c.launches for c in counters}
    log(f"finisher path launches (counters from 0): {launches}")
    assert all(launches.values()), launches

    rows["designs_readme"] = _design_turns(
        (_pde(), README), readme_adam, 1024, 50, "README")
    rows["designs_wide"] = _design_turns(
        (_pde(), WIDE), wide_adam, WIDE_BATCH, 5, "wide")
    return launches, rows


# Phase 10: the collocation features and the objective (ROADMAP Queue 1
# item 10) through the public Solver.  The stiff ODE of examples/09 and of
# the RBA study in BENCHMARKS.md:722-745, and its exact solution.
STIFF = dict(ndims=1, initial_condition=0.0, activation="Tanh",
             layout="fafaf", features=[32, 32, 1])
COLLOCATION_SEEDS = tuple(range(6))
# examples/09's fit, uniform and with ``adaptive=ADAPTIVE_POOL``; the RBA
# study's fit on a fixed batch, with and without ``rba=RBA_ETA_GAMMA``;
# the causal arm's eps on w3 and the batches of its plain MSE.  These and
# the chains above are also those of tests/collocation_seed_study.py.
ADAPTIVE_FIT = dict(niters=1500, batch_size=128, lr=0.01)
ADAPTIVE_POOL = 8
RBA_FIT = dict(niters=2000, batch_size=256, lr=0.01, resample=False)
RBA_ETA_GAMMA = (0.01, 0.99)
CAUSAL_EPS = 5.0
MSE_BATCHES = 50
# pydens_tpu on the CPU, seeds 0-5 (tests/collocation_seed_study.py jax;
# tests/test_torch_collocation_reference.py recomputes them): the median
# and the largest mean |residual| of examples/09's adaptive fit.
ADAPTIVE_JAX = dict(median=0.1998, max=0.7611)
# 3x pydens_tpu's median and max error (BENCHMARKS.md:740: 0.026, 0.069).
RBA_BOUNDS = dict(median=0.078, max=0.207)
HELMHOLTZ_K = 12.0
BEAM_LT = {"equation": 1.0, "constraint_0": 1.0, "constraint_1": 1.0}
# Each phase-10 Taylor chain (the network and the closure of its solver's
# plan, ``_assert_chain``), the point counts its Taylor kernels take there,
# and the points of the MLP kernel's predicts on its network.
COLLOCATION_CHAINS = {
    # examples/09's solver: the adaptive step's batch, its candidate pool
    # (8 x 128 candidates less the uniform half, forward only), RBA's fixed
    # batch, Solver.residual's 2,000 points; RBA's predict on 2,000.
    "ex09": (dict(layout=STIFF["layout"], features=STIFF["features"],
                  act=STIFF["activation"], in_dim=1, closure=[(0,)]),
             (128, 960, 256, 2000), (2000,)),
    # examples/31's Helmholtz solver: batch 1,024; its predict on 201.
    "ex31": (dict(layout="fa fa fa f", features=[48, 48, 48, 1], act="Tanh",
                  in_dim=1, closure=[(0,), (0, 0)]), (1024,), (201,)),
    # examples/23's solvers: Adam at 2,048, L-BFGS at 4,096, the
    # variational plan of order 1 and the strong form of order 2; the
    # predict on 401, and on 101 for the beam, whose network this is too
    # (its order-4 chain takes the plain traversal).
    "ex23_variational": (dict(layout="fa fa f", features=[24, 24, 1],
                              act="Tanh", in_dim=1, closure=[(0,)]),
                         (2048, 4096), (401, 101)),
    "ex23_residual": (dict(layout="fa fa f", features=[24, 24, 1],
                           act="Tanh", in_dim=1, closure=[(0,), (0, 0)]),
                      (2048, 4096), ()),
}


def _stiff_ode():
    from pydens_tpu_torch import D, exp

    def ode(f, x):
        return D(f, x) - 100 * exp(-2000 * (x - 0.8) ** 2)
    return ode


def _stiff_exact(xs):
    a = np.sqrt(2000.0)
    erf = np.vectorize(math.erf)
    return 50 * np.sqrt(np.pi / 2000) * (erf(a * (xs - 0.8)) + erf(a * 0.8))


def _kind_tally(solver):
    """Steps of each kind over the solver's cached fit steps: eager runs,
    replays and captured graphs of the training step and of the rebalance
    step of loss balancing."""
    steps = list(solver._step_cache.values())
    return dict(eager=sum(s.eager_steps for s in steps),
                replays=sum(s.replays for s in steps),
                graph=sum(s.graph is not None for s in steps),
                rebalance_eager=sum(s.rebalance_eager for s in steps),
                rebalance_replays=sum(s.rebalance_replays for s in steps),
                rebalance_graph=sum(s.rebalance_graph is not None
                                    for s in steps))


def _kind_launches(step):
    """Taylor forward and backward launches of one training step and of one
    rebalance step of ``step``, by its design: adaptive adds a forward pass
    over the candidate pool; a grad rebalance pulls each term back once
    (the equation term through the backward kernel; the constraints go
    through the plain network), an NTK rebalance the equation block once a
    probe (phase 10's equation blocks are larger than 4 entries, so they
    take probes)."""
    opts = step.options
    train = (2 if opts.adaptive else 1, 1)
    if not opts.balance_every:
        return train, (0, 0)
    pulls = len(step.probes[0]) if opts.balance_mode == "ntk" else 1
    return train, (1, 1 + pulls)


def collocation_fit(solver, tag, kernels=True, **fit):
    """One fit through graphs, checked by its tallies: every step ran once
    (eagerly or replayed, of its kind), and each eager step and each
    capture launched the Taylor kernels as its kind's design says, or
    never when the chain is outside the kernels' scope (``kernels``).
    Returns it/s (host clock ending in a synchronize, warm-ups and
    captures included), the tally and the launches."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward)
    before, counts = _kind_tally(solver), [c.launches for c in counters]
    sync()
    t0 = time.perf_counter()
    solver.fit(progress=False, **fit)
    sync()
    wall = time.perf_counter() - t0
    after = _kind_tally(solver)
    d = {k: after[k] - before[k] for k in after}
    launches = [c.launches - n for c, n in zip(counters, counts)]
    steps = (d["eager"] + d["replays"] + d["rebalance_eager"]
             + d["rebalance_replays"])
    assert steps == fit["niters"], (tag, d)
    assert d["replays"] > 0 or after["graph"] > 0, (tag, d)
    step = list(solver._step_cache.values())[-1]
    train, rebalance = _kind_launches(step)
    wrapper = [(d["eager"] + d["graph"]) * t
               + (d["rebalance_eager"] + d["rebalance_graph"]) * r
               for t, r in zip(train, rebalance)]
    device = [(d["eager"] + d["replays"]) * t
              + (d["rebalance_eager"] + d["rebalance_replays"]) * r
              for t, r in zip(train, rebalance)]
    if kernels:
        assert launches == wrapper, (tag, launches, wrapper, d)
    else:
        assert launches == [0, 0], (tag, launches)
    losses = np.asarray(solver.losses[-fit["niters"]:])
    assert np.isfinite(losses).all(), tag
    row = dict(it_s=fit["niters"] / wall, tally=d, wrapper_launches=launches,
               device_launches=device if kernels else [0, 0],
               first_loss=float(losses[0]), final_loss=float(losses[-1]))
    log(f"collocation {tag}: {fit['niters']} steps in {wall:.3f} s, "
        f"{row['it_s']:.1f} it/s, loss {losses[0]:.4e} -> {losses[-1]:.4e}; "
        f"tally {d}; Taylor wrapper launches {launches}"
        + ("" if kernels else " (the plain traversal: the chain is outside "
           "the kernels' scope)"))
    return row


def graph_launches(step, rebalance=False, kernels=True, reps=5,
                   windows=5):
    """``torch.profiler`` over ``reps`` replays of one kind's graph of a
    fit step (its training step, or its rebalance step): the Taylor
    kernels' launches, the device ops and busy ms per replay.  The device
    index is set to 0 before each replay (one fill more per replay,
    counted in the ops).  A warm-up round is recorded and dropped, as in
    ``step_profile``, and a window whose Taylor counts are not those of
    the kind's design (``_kind_launches``; none without ``kernels``) is
    taken again, up to ``windows`` times (``windows_taken``): the profiler
    now and then drops a window's records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    graph = step.rebalance_graph if rebalance else step.graph
    assert graph is not None
    expect = (_kind_launches(step)[int(rebalance)] if kernels else (0, 0))
    for taken in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    step.index.zero_()
                    graph.replay()
                sync()
                prof.step()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
        counts = [sum(k in e.name for e in dev) / reps
                  for k in TAYLOR_KERNELS]
        if counts == list(expect):
            break
        log(f"profiler window {taken}: {len(dev)} device records, Taylor "
            f"kernels {counts} per replay, {list(expect)} by design; "
            "taking another")
    row = {f"{k}_per_step": c for k, c in zip(TAYLOR_KERNELS, counts)}
    row.update(device_ops=len(dev) / reps, device_busy_ms=sum(
        e.time_range.elapsed_us() for e in dev) / 1e3 / reps,
        windows_taken=taken)
    return row


def _assert_chain(solver, chain):
    """The solver's network and plan closure are ``chain``'s, the chain
    that ``phase_kernels`` holds against its plain version."""
    m = solver.model
    got = dict(layout=m.layout, features=m.features, act=m.activation,
               in_dim=m.net.in_dim,
               closure=m.plan_closure(solver._plan_derivs))
    assert got == chain, (got, chain)
    return solver


def _in_turns(arms, make, fit_of, tag, seeds=None, metric=None, repeats=1):
    """The arms on fresh solvers, in turns (the arm order reversed on every
    other round): a round for each seed of ``seeds`` (``make(arm, seed)``),
    else ``repeats`` rounds of one configuration (``make(arm, None)``),
    which differ only in their rates.  ``collocation_fit`` rows and
    ``metric(solver)`` per arm and round; the last solver of each arm is
    kept."""
    rounds = ([(f"seed {seed}", seed) for seed in seeds] if seeds is not None
              else [(f"repeat {i}", None) for i in range(repeats)])
    rows, kept = {a: [] for a in arms}, {}
    for i, (label, seed) in enumerate(rounds):
        for arm in (arms if i % 2 == 0 else arms[::-1]):
            solver = make(arm, seed)
            fit, kernels = fit_of(arm)
            row = collocation_fit(solver, f"{tag} {arm} {label}", kernels,
                                  **fit)
            if metric is not None:
                row["metric"] = metric(solver)
            rows[arm].append(row)
            kept[arm] = solver
    return rows, kept


def phase_collocation():
    """Phase 10, the collocation features through the public Solver with
    graphs, each arm at its source's width, steps and batch, the launch
    counters set to 0 just before and read just after each arm:
    adaptive (examples/09) against uniform fits, RBA (the stiff ODE of
    BENCHMARKS.md:722-745 on a fixed batch) against the fixed batch alone,
    both on seeds 0-5; causal ``w3`` at eps 0 and 5 against its plain fit,
    then eps annealed on the cached step; grad balancing on the raw beam of
    tests/test_loss_balancing.py (order 4: the plain traversal) against
    unbalanced fits; NTK balancing on examples/31's Helmholtz equation and
    grad balancing on it through the kernels; Deep Ritz (examples/23)
    against the strong form.  The causal, beam and Helmholtz arms are
    seeded as their sources are and run twice in turns, for their rates.
    Launches per step of the new step kinds from ``torch.profiler`` over
    replays of their graphs.  Each solver's chain is one that
    ``phase_kernels`` checks (``COLLOCATION_CHAINS``)."""
    from pydens_tpu_torch import D, HaltonSampler, Solver, sign
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    from pydens_tpu_torch.utils.criteria import mse_loss
    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward,
                fm.fused_mlp_forward)
    out, path = {}, {}

    def start():
        for c in counters:
            c.launches = 0

    def read(arm):
        path[arm] = {c.__name__: c.launches for c in counters}

    def rates(rows):
        return {arm: [r["it_s"] for r in rs] for arm, rs in rows.items()}

    # Adaptive: examples/09 and its uniform fit, seeds 0-5.
    xs = np.linspace(0, 1, 2000, dtype=np.float32)

    def mean_residual(solver):
        before = ft.fused_taylor_forward.launches
        r = solver.residual(xs)
        assert r.shape == (2000, 1) and np.isfinite(r).all()
        assert ft.fused_taylor_forward.launches == before + 1
        return float(r.mean())

    start()
    rows, kept = _in_turns(
        ("adaptive", "uniform"),
        lambda arm, seed: _assert_chain(
            Solver(_stiff_ode(), seed=seed, **STIFF),
            COLLOCATION_CHAINS["ex09"][0]),
        lambda arm: (dict(ADAPTIVE_FIT,
                          **(dict(adaptive=ADAPTIVE_POOL)
                             if arm == "adaptive" else {})),
                     True),
        "adaptive", COLLOCATION_SEEDS, mean_residual)
    read("adaptive")
    res = {arm: [r["metric"] for r in rs] for arm, rs in rows.items()}
    ratio = [a / u for a, u in zip(res["adaptive"], res["uniform"])]
    adaptive = dict(mean_residual=res, adaptive_over_uniform=ratio,
                    it_s=rates(rows),
                    step=graph_launches(list(
                        kept["adaptive"]._step_cache.values())[0]),
                    uniform_step=graph_launches(list(
                        kept["uniform"]._step_cache.values())[0]))
    med = {arm: float(np.median(v)) for arm, v in res.items()}
    adaptive.update(median=med,
                    median_ratio=float(np.median(ratio)))
    log(f"adaptive: mean |residual| {json.dumps(res)}, medians {med}; "
        f"adaptive / uniform {[round(x, 3) for x in ratio]} (the example's "
        f"0.6 held on {sum(x < 0.6 for x in ratio)} of {len(ratio)} seeds; "
        "pydens_tpu on the CPU: 2 of 6); launches per replayed step "
        f"{json.dumps(adaptive['step'])}")
    assert adaptive["step"]["taylor_fwd_kernel_per_step"] == 2.0
    assert adaptive["step"]["taylor_bwd_kernel_per_step"] == 1.0
    # The example's own assert, adaptive < 0.6 x uniform, on the medians
    # over the seeds (one seed's ratio spreads several-fold in both
    # packages); the paired ratio below 1 on most seeds; the adaptive
    # median within 1.5x pydens_tpu's, and the largest within 3x.
    assert med["adaptive"] < 0.6 * med["uniform"], med
    assert adaptive["median_ratio"] < 1.0, ratio
    assert med["adaptive"] < 1.5 * ADAPTIVE_JAX["median"], (med,
                                                             ADAPTIVE_JAX)
    assert max(res["adaptive"]) < 3 * ADAPTIVE_JAX["max"], (res,
                                                            ADAPTIVE_JAX)
    out["adaptive"] = adaptive
    del kept
    free_card()

    # RBA: the fixed batch with and without rba.
    truth = _stiff_exact(xs.astype(np.float64))

    def max_error(solver):
        return float(np.abs(solver.predict(xs).ravel() - truth).max())

    start()
    rows, kept = _in_turns(
        ("rba", "fixed"),
        lambda arm, seed: _assert_chain(
            Solver(_stiff_ode(), seed=seed, **STIFF),
            COLLOCATION_CHAINS["ex09"][0]),
        lambda arm: (dict(RBA_FIT, **(dict(rba=RBA_ETA_GAMMA)
                                      if arm == "rba" else {})), True),
        "rba", COLLOCATION_SEEDS, max_error)
    read("rba")
    err = {arm: [r["metric"] for r in rs] for arm, rs in rows.items()}
    rba = dict(max_error=err, it_s=rates(rows),
               median={a: float(np.median(v)) for a, v in err.items()},
               max={a: float(np.max(v)) for a, v in err.items()},
               step=graph_launches(list(
                   kept["rba"]._step_cache.values())[0]),
               fixed_step=graph_launches(list(
                   kept["fixed"]._step_cache.values())[0]))
    log(f"rba: max error {json.dumps(err)}; median {rba['median']}, max "
        f"{rba['max']} (bounds {RBA_BOUNDS}); launches per replayed step "
        f"{json.dumps(rba['step'])}")
    assert rba["step"]["taylor_fwd_kernel_per_step"] == 1.0
    assert rba["step"]["taylor_bwd_kernel_per_step"] == 1.0
    assert rba["median"]["rba"] < RBA_BOUNDS["median"], rba["median"]
    assert rba["max"]["rba"] < RBA_BOUNDS["max"], rba["max"]
    out["rba"] = rba
    del kept
    free_card()

    # Causal: w3 at full batch and steps, plain, eps 0 and eps 5, in turns;
    # then eps 20 on the eps-5 solver, which replays the cached graph.
    eq, kw, fits = _tutorial("w3")
    w3_fit = fits[0][1]
    start()
    rows, kept = _in_turns(
        ("plain", "causal0", "causal5"),
        lambda arm, seed: _assert_chain(
            Solver(eq, seed=0, device="cuda", **kw),
            TUTORIAL_CHAINS["w3"][0]),
        lambda arm: (dict(w3_fit, **({} if arm == "plain" else dict(
            causal=0.0 if arm == "causal0" else CAUSAL_EPS))), True),
        "causal w3", repeats=2)
    plain = np.asarray(kept["plain"].losses)
    zero = np.asarray(kept["causal0"].losses)
    np.testing.assert_allclose(zero[:20], plain[:20], rtol=1e-5)
    np.testing.assert_allclose(zero[-1], plain[-1], rtol=1e-3)
    solver = kept["causal5"]
    five = np.asarray(solver.losses)
    assert _falling(five), "causal 5 fit not falling"
    # The eps-5 solver's plain MSE over fresh batches, drawn before the
    # anneal below moves theta (pydens_tpu on the CPU,
    # tests/collocation_seed_study.py: 9.53-9.63 on seeds 0-2; plain w3
    # 6.50-6.60).
    loss_fn = solver._build_loss_fn((("equation", 1.0),), mse_loss,
                                    use_plan=True)
    theta = loss_fn.spec.flatten(solver.model.params).detach()
    gen = torch.Generator(device="cuda").manual_seed(123)
    mse = float(np.mean([float(loss_fn(theta, w3_fit["sampler"].sample_device(
        gen, w3_fit["batch_size"])).detach())
        for _ in range(MSE_BATCHES)]))
    # Annealing: eps 20 on the eps-5 solver replays its graph.
    graphs = _kind_tally(solver)["graph"]
    before = [c.launches for c in counters[:2]]
    anneal = collocation_fit(solver, "causal w3 eps 20", True,
                             **dict(w3_fit, niters=500, causal=20.0))
    assert _kind_tally(solver)["graph"] == graphs
    assert [c.launches for c in counters[:2]] == before, \
        "annealing recaptured the step"
    assert len(solver._step_cache) == 1
    read("causal")
    causal = dict(it_s=rates(rows), anneal_it_s=anneal["it_s"],
                  eps0_max_rel_diff=float(np.max(np.abs(zero - plain)
                                                 / np.abs(plain))),
                  eps0_bitwise=bool(np.array_equal(zero, plain)),
                  eps5_plain_mse_50_batches=mse,
                  step=graph_launches(list(solver._step_cache.values())[0]),
                  plain_step=graph_launches(list(
                      kept["plain"]._step_cache.values())[0]))
    log(f"causal w3: {json.dumps(causal)} (band {TUTORIAL_BANDS['w3']})")
    assert mse < TUTORIAL_BANDS["w3"], mse
    assert causal["step"]["taylor_fwd_kernel_per_step"] == 1.0
    out["causal"] = causal
    del kept, solver
    free_card()

    # Grad balancing: tests/test_loss_balancing.py's raw beam, order 4.
    xs_b = np.linspace(0, 1, 101, dtype=np.float32)
    beam_true = 16.0 * xs_b ** 2 * (1 - xs_b) ** 2
    left, right = np.zeros(1, np.float32), np.ones(1, np.float32)

    def beam(arm, seed):
        return Solver(lambda f, x: D(D(D(D(f, x), x), x), x) - 384.0,
                      ndims=1, boundary_condition=0, seed=0,
                      layout="fa fa f", features=[24, 24, 1],
                      activation="Tanh",
                      constraints=(lambda f, x: f.grad(left, wrt=0),
                                   lambda f, x: f.grad(right, wrt=0)))

    start()
    rows, kept = _in_turns(
        ("balanced", "unbalanced"), beam,
        lambda arm: (dict(niters=2500, batch_size=512, lr=0.01,
                          loss_terms=BEAM_LT,
                          **(dict(loss_balancing=True)
                             if arm == "balanced" else {})), False),
        "grad balancing beam", repeats=2,
        metric=lambda s: float(np.abs(s.predict(xs_b).ravel()
                                      - beam_true).max()))
    read("grad_beam")
    wts = kept["balanced"].history[-1]["balanced_weights"]
    step = list(kept["balanced"]._step_cache.values())[0]
    assert step.rebalance_eager + step.rebalance_replays == 10
    grad_beam = dict(
        max_error={a: [r["metric"] for r in rs] for a, rs in rows.items()},
        it_s=rates(rows), balanced_weights=wts,
        route="plain traversal (order 4, outside the Taylor kernels)",
        step=graph_launches(step, kernels=False),
        rebalance_step=graph_launches(step, rebalance=True, kernels=False))
    log(f"grad balancing beam: {json.dumps(grad_beam)}")
    assert all(e > 0.05 for e in grad_beam["max_error"]["unbalanced"])
    assert all(e < 0.01 for e in grad_beam["max_error"]["balanced"])
    assert wts[0] == 1.0 and min(wts[1:]) > 10.0, wts
    out["grad_beam"] = grad_beam
    del kept, step
    free_card()

    # NTK balancing: examples/31, and grad balancing through the kernels.
    k = HELMHOLTZ_K
    zero = np.array([0.0], np.float32)
    xs_h = np.linspace(0.0, 1.0, 201, dtype=np.float32)

    def helmholtz(arm, seed):
        return _assert_chain(Solver(
            lambda f, x: D(D(f, x), x) + k * k * f, ndims=1, seed=0,
            layout="fa fa fa f", features=[48, 48, 48, 1], activation="Tanh",
            constraints=(lambda f, x: f(zero),
                         lambda f, x: f.grad(zero, wrt=0) - k)),
            COLLOCATION_CHAINS["ex31"][0])

    start()
    rows, kept = _in_turns(
        ("ntk", "grad"), helmholtz,
        lambda arm: (dict(niters=4000, batch_size=1024, lr=0.002,
                          loss_terms=BEAM_LT,
                          loss_balancing="ntk" if arm == "ntk" else True),
                     True),
        "helmholtz", repeats=2,
        metric=lambda s: float(np.abs(s.predict(xs_h).ravel()
                                      - np.sin(k * xs_h)).max()))
    read("helmholtz")
    ntk = dict(max_error={a: [r["metric"] for r in rs]
                          for a, rs in rows.items()},
               it_s=rates(rows),
               balanced_weights={a: s.history[-1]["balanced_weights"]
                                 for a, s in kept.items()})
    for arm, s in kept.items():
        step = list(s._step_cache.values())[0]
        assert step.rebalance_eager + step.rebalance_replays == 10
        ntk[f"{arm}_rebalance_step"] = graph_launches(step, rebalance=True)
        ntk[f"{arm}_step"] = graph_launches(step)
    log(f"helmholtz balancing: {json.dumps(ntk)}")
    w = np.asarray(ntk["balanced_weights"]["ntk"])
    assert w[0] == 1.0 and np.all(np.isfinite(w)) and np.all(w > 0), w
    assert max(ntk["max_error"]["ntk"]) < 0.03, ntk["max_error"]
    for arm, bwd in (("ntk", 5.0), ("grad", 2.0)):
        row = ntk[f"{arm}_rebalance_step"]
        assert row["taylor_fwd_kernel_per_step"] == 1.0, (arm, row)
        assert row["taylor_bwd_kernel_per_step"] == bwd, (arm, row)
    out["helmholtz"] = ntk
    del kept, step, s
    free_card()

    # Deep Ritz: examples/23, variational and strong form.
    xs_r = np.linspace(0, 1, 401, dtype=np.float32)
    u_true = np.where(xs_r <= 0.5, -xs_r ** 2 / 2 + xs_r / 4,
                      xs_r ** 2 / 2 - 3 * xs_r / 4 + 0.25)

    def source(x):
        return sign(0.5 - x)

    equations = {"variational": lambda f, x: 0.5 * D(f, x) ** 2
                 - source(x) * f,
                 "residual": lambda f, x: D(D(f, x), x) + source(x)}
    start()
    ritz = {"rel_l2": {}, "adam_it_s": {}, "lbfgs": {}}
    for arm in ("variational", "residual"):
        s = _assert_chain(Solver(
            equations[arm], ndims=1, seed=0, boundary_condition=0,
            layout="fa fa f", features=[24, 24, 1], activation="Tanh",
            **({"formulation": "variational"}
               if arm == "variational" else {})),
            COLLOCATION_CHAINS[f"ex23_{arm}"][0])
        qmc = HaltonSampler(dim=1)
        row = collocation_fit(s, f"deep ritz {arm} Adam", True, niters=4000,
                              batch_size=2048, lr=5e-3, sampler=qmc)
        lbfgs = run_finisher(s, "LBFGS", 500, 4096, f"deep ritz {arm}",
                             sampler=qmc)
        pred = s.predict(xs_r).ravel()
        ritz["rel_l2"][arm] = float(np.linalg.norm(pred - u_true)
                                    / np.linalg.norm(u_true))
        ritz["adam_it_s"][arm] = row["it_s"]
        ritz["lbfgs"][arm] = {k: lbfgs[k] for k in (
            "it_s", "final_loss", "per_step_mean", "taylor_fwd_per_step")}
        del s
        free_card()
    read("deep_ritz")
    log(f"deep ritz: {json.dumps(ritz)} (pydens_tpu, BENCHMARKS.md:564: "
        "0.0008 vs 0.0164)")
    rel = ritz["rel_l2"]
    assert rel["variational"] < 0.005, rel
    assert rel["variational"] < rel["residual"] / 3, rel
    out["deep_ritz"] = ritz
    log(f"collocation path launches (counters from 0 at each arm): "
        f"{json.dumps(path)}")
    return path, out


def _clone_tree(tree):
    """A copy of a parameter tree (dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def profile_steps(steps=50):
    """Per-step cost of the last fit of ``w1``-``w5`` through graphs, with
    the guard on and off (``step_profile``: host ms per step, device ops
    and busy ms per step, Taylor launches per step).  A tutorial's earlier
    fits run in full first."""
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
            row = dict(workload=name, stop_on_nan=guard, **step_profile(
                solver, dict(fits[-1][1], stop_on_nan=guard), steps))
            log(json.dumps(row))
            rows.append(row)
            del solver
            free_card()
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


def _load_old_jvp(source):
    """An earlier csrc/fused_taylor.cu built from ``source`` into
    build/jvp_turns/, with the C entry of the first tangent kernel:
    pdt_taylor_jvp(x, w, v, tab, out, tout, n, P, n_streams, wmax, out_dim,
    grid, stream), 16 points a tile."""
    import ctypes
    from pathlib import Path
    from pydens_tpu_torch.ops._build import _NVCC_FLAGS, _nvcc
    out_dir = Path(__file__).resolve().parent / "build" / "jvp_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / "libtaylor_old.so"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(target),
                           str(source)], check=True, capture_output=True,
                          text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "taylor_jvp" in line or "registers" in line:
            log(f"  old ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(target))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pdt_taylor_jvp.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.pdt_taylor_jvp.restype = ctypes.c_int
    return lib


def _old_jvp_grid(plan, n, sm_count):
    """The first tangent kernel's launch: the weights twice and four
    16-point tile states a block, two blocks an SM where they fit."""
    ld = plan.n_streams * 16 + 4
    smem = 4 * (2 * -(-plan.n_params // 4) * 4 + 4 * plan.wmax * ld)
    per_sm = 2 if 2 * (smem + 1024) <= 233_472 else 1
    return min(-(-n // 16), sm_count * per_sm), per_sm, smem


def jvp_turns(old_source, reps=20):
    """The tangent kernel of an earlier csrc/fused_taylor.cu (``old_source``:
    the first design) against this tree's, in turns (old, new, new, old; CUDA
    events, ``reps`` calls each of the bare C entries) at its four
    phase-3 shapes, both held to the plain twin at VALUE_TOL; this tree's
    kernel also through its wrapper."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    from pydens_tpu_torch.ops._build import load_library
    old, lib = _load_old_jvp(old_source), load_library()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for tag in ("readme_n1024", "wide", "wide_heat", "ode_n512"):
        case = dict(JVP_SHAPES[tag])
        n = case["n"]
        plan, packed, x = _taylor_case(
            case.get("layout", "fa fa fa f"), case["features"], "Tanh", n, 0,
            case.get("closure", POISSON_CLOSURE), case.get("in_dim", 2))
        v = torch.randn(plan.n_params, device=x.device,
                        generator=torch.Generator(x.device).manual_seed(1))
        shape = (n, plan.n_streams * plan.out_dim)
        outs = [torch.empty(shape, device=x.device) for _ in range(4)]
        tab = plan.device_table(x.device)
        stream = torch.cuda.current_stream().cuda_stream
        old_grid, old_per_sm, old_smem = _old_jvp_grid(plan, n, sm_count)
        per_sm = ft.jvp_blocks_per_sm(plan, x.device)
        grid, _ = plan.jvp_launch_shape(n, sm_count, per_sm)

        def old_call():
            assert old.pdt_taylor_jvp(
                x.data_ptr(), packed.data_ptr(), v.data_ptr(), tab.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), n, plan.n_params,
                plan.n_streams, plan.wmax, plan.out_dim, old_grid,
                stream) == 0
            return outs[0], outs[1]

        def new_call():
            assert lib.pdt_taylor_jvp(
                x.data_ptr(), packed.data_ptr(), v.data_ptr(), tab.data_ptr(),
                outs[2].data_ptr(), outs[3].data_ptr(), n, plan.n_params,
                plan.n_streams, plan.wmax, plan.out_dim, plan.jvp_tile,
                int(plan.jvp_resident), grid, stream) == 0
            return outs[2], outs[3]
        ref, tref = ft.fused_taylor_jvp_plain(packed, x, v, plan)
        for fn in (old_call, new_call):
            out, tout = fn()
            sync()
            torch.testing.assert_close(out, ref, **VALUE_TOL)
            torch.testing.assert_close(tout, tref, **VALUE_TOL)
        o1, n1, n2, o2 = (time_ms(f, reps) for f in (
            old_call, new_call, new_call, old_call))
        wrapped = time_ms(lambda: ft.fused_taylor_jvp(packed, x, v, plan),
                          reps)
        b, by, work = taylor_bounds(plan, n)["jvp"]
        rows[tag] = dict(old=[o1, o2], new=[n1, n2], wrapper=wrapped,
                         bound_ms=b, bound_by=by, old_blocks_per_sm=old_per_sm,
                         old_smem_bytes=old_smem, tile=plan.jvp_tile,
                         resident=plan.jvp_resident, blocks_per_sm=per_sm,
                         smem_bytes=plan.jvp_smem)
        log(f"jvp turns {tag} {case['features']} closure "
            f"{plan.n_streams - 1} n={n}: old {o1:.4f} / {o2:.4f} ms "
            f"({old_per_sm} blocks/SM, {old_smem} B), new {n1:.4f} / "
            f"{n2:.4f} ms ({per_sm} blocks/SM on the card, "
            f"{plan.jvp_smem} B, {plan.jvp_tile} points a tile, weights "
            f"{'resident' if plan.jvp_resident else 'streamed'}); speed-up "
            f"{(o1 + o2) / (n1 + n2):.2f}x; {work}: old "
            f"{_share((o1 + o2) / 2, b)}, new {_share((n1 + n2) / 2, b)} "
            f"({by}); through fused_taylor_jvp {wrapped:.4f} ms")
    print(json.dumps({"jvp_turns": rows}), flush=True)


def w3_repeat():
    """Queue 3's repeatability probe: ``w3``'s eager fit (no graphs) for its
    full 1000 steps, twice under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (recording the ops that warn: those without a
    deterministic implementation) and twice without, each on a fresh
    solver of seed 0; then, after a fit through graphs and a profiler
    window (what phase 7 runs first), twice more.  Prints the ops and
    whether each pair agreed bit for bit."""
    import warnings
    from pydens_tpu_torch import Solver
    eq, kw, fits = _tutorial("w3")

    def run(det):
        torch.use_deterministic_algorithms(det, warn_only=True)
        solver = Solver(eq, seed=0, device="cuda", **kw)
        solver._capture_steps = False
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                solver.fit(progress=False, **fits[0][1])
                sync()
        finally:
            torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message)[:160] for w in caught
                      if "determinis" in str(w.message)})
        return np.asarray(solver.losses), ops

    (d1, ops), (d2, _), (n1, _), (n2, _) = (run(det) for det in
                                            (True, True, False, False))
    # The same pair after what phase 7 runs before its eager w3 fits: a
    # fit through graphs and a torch.profiler window of it.
    s = Solver(eq, seed=0, device="cuda", **kw)
    s.fit(progress=False, **fits[0][1])
    step_profile(s, fits[0][1])
    del s
    free_card()
    (a1, _), (a2, _) = run(False), run(False)
    row = {"warned_ops": ops,
           "after_graph_and_profiler_bitwise_equal": bool(
               np.array_equal(a1, a2)),
           "after_vs_fresh_max_rel_diff": float(
               np.max(np.abs(a1 - n1) / np.abs(n1))),
           "deterministic_bitwise_equal": bool(np.array_equal(d1, d2)),
           "default_bitwise_equal": bool(np.array_equal(n1, n2)),
           "default_max_rel_diff": float(np.max(np.abs(n1 - n2)
                                                / np.abs(n2))),
           "deterministic_vs_default_max_rel_diff": float(
               np.max(np.abs(d1 - n1) / np.abs(n1)))}
    print(json.dumps({"w3_repeat": row}), flush=True)


def main():
    name, smi = phase_device()
    phase_build()
    sync()
    if sys.argv[1:] == ["--w3-repeat"]:
        w3_repeat()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--finishers"]:
        print(json.dumps({"finishers": phase_finishers()[1]}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--collocation"]:
        with _plain_refused():
            print(json.dumps({"collocation": phase_collocation()[1]}),
                  flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--profile"]:
        profile_steps()
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--mlp-turns"]:
        mlp_turns(sys.argv[2])
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--jvp-turns"]:
        jvp_turns(sys.argv[2])
        print(smi, flush=True)
        return 0
    taylor, tut_taylor, mlp, tut_mlp, jvp = phase_kernels()
    launches, w1_device, w1_prof = phase_poisson()
    phase_wide_fit()
    tutorials = phase_tutorials()
    print(json.dumps({"graph_vs_eager": phase_graph_vs_eager(),
                      "loop_features": phase_loop_features()}), flush=True)
    finisher_launches, finishers = phase_finishers()
    print(json.dumps({"finishers": finishers}), flush=True)
    with _plain_refused():
        collocation_launches, collocation = phase_collocation()
    print(json.dumps({"collocation": collocation}), flush=True)
    path_launches = {k: {"w1": launches[k],
                         **{w: t[0][k] for w, t in tutorials.items()},
                         **{f"p10_{arm}": n[k] for arm, n
                            in collocation_launches.items()}}
                     for k in launches}
    # Launches on the card: the Taylor kernels once per fit step (eager or
    # replayed), the MLP kernel once per predict (never captured).
    device_launches = {"w1": w1_device,
                       **{w: t[1] for w, t in tutorials.items()}}
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

    def entry(name, src, replaces, times, key, err, table, kernel=None):
        # No single PyTorch call computes a Taylor traversal or a layout
        # chain with its skip stack: library_ms is null.  ``launches`` is
        # the wrapper's count on the main path (eager steps and captures);
        # a captured kernel's launches on the card, and per replayed step,
        # follow.
        graph = ({"path_device_launches": device_launches,
                  "graph_launches_per_step": w1_prof[f"{kernel}_per_step"]}
                 if kernel else {"path_device_launches": path_launches[name]})
        return {"name": name, "route": "cuda",
                "source": f"pydens_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": times[key],
                "plain_ms": times[f"{key}_plain"],
                "bound_ms": times[f"{key}_bound"],
                "bound_by": times[f"{key}_bound_by"], "library_ms": None,
                **shape_times(key, table),
                "path_launches": path_launches[name], **graph}

    # The tangent kernel has no Pallas counterpart (JAX takes J v by XLA
    # autodiff of its plan, pydens_tpu/solver.py:1349); its launches are
    # the finisher path's (phase 9), its per-step launches the LM steps'.
    jvp_main = jvp["readme_n1024"][1]
    jvp_entry = {
        "name": "fused_taylor_jvp", "route": "cuda",
        "source": "pydens_tpu_torch/csrc/fused_taylor.cu",
        "replaces": "pydens_tpu/solver.py:1349 (jax.linearize of the plan; "
                    "no Pallas kernel)",
        "launches": finisher_launches["fused_taylor_jvp"],
        "max_abs_err": max(e for e, _ in jvp.values()),
        "ms": jvp_main["jvp"], "plain_ms": jvp_main["jvp_plain"],
        "bound_ms": jvp_main["jvp_bound"],
        "bound_by": jvp_main["jvp_bound_by"], "library_ms": None,
        **{f"{tag}_{kind}ms": times["jvp" + suffix]
           for tag, (_, times) in jvp.items()
           for kind, suffix in (("", ""), ("plain_", "_plain"),
                                ("bound_", "_bound"))},
        "plan": {tag: {k: times[k] for k in ("jvp_tile", "jvp_resident",
                                             "jvp_blocks_per_sm",
                                             "jvp_smem_bytes")}
                 for tag, (_, times) in jvp.items()},
        "path_launches": finisher_launches,
        "lm_launches_per_step":
            finishers["ode_lm"]["taylor_jvp_kernel_per_step"]}
    kernels = [
        entry("fused_taylor_forward", "fused_taylor.cu",
              "pydens_tpu/ops/pallas_taylor.py:386", main_taylor, "fwd",
              fwd_err, shapes, "taylor_fwd_kernel"),
        entry("fused_taylor_backward", "fused_taylor.cu",
              "pydens_tpu/ops/pallas_taylor.py:428", main_taylor, "bwd",
              bwd_err, shapes, "taylor_bwd_kernel"),
        entry("fused_mlp_forward", "fused_mlp.cu",
              "pydens_tpu/ops/pallas_mlp.py:92", main_mlp, "fwd",
              max(e for e, _ in list(mlp.values()) + list(tut_mlp.values())),
              mlp_shapes),
        jvp_entry,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
