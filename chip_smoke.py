"""Smoke run of pydens_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # per-step profile of w1-w5 only
    python3 chip_smoke.py --mlp-turns OLD.cu   # MLP kernel: OLD.cu vs this
    python3 chip_smoke.py --jvp-turns OLD.cu   # tangent kernel: OLD.cu vs this
    python3 chip_smoke.py --states-turns   # Taylor backward: states vs recompute
    python3 chip_smoke.py --finishers  # phases 1, 2 and 9 only
    python3 chip_smoke.py --collocation   # phases 1, 2 and 10 only
    python3 chip_smoke.py --model-features   # phases 1, 2 and 11 only
    python3 chip_smoke.py --ensembles  # phases 1, 2 and 12 only
    python3 chip_smoke.py --symbolic   # phases 1, 2 and 13 only
    python3 chip_smoke.py --scale-out  # phases 1, 2 and 14 only
    python3 chip_smoke.py --examples   # phases 1, 2 and 15 only
    python3 chip_smoke.py --notebooks  # phases 1, 2 and 16 only
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
   width 64; the Taylor kernels as a fit runs them (the forward keeping
   its states, the backward reading them, bitwise the backward that
   recomputes them, which is timed beside it);
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
   and busy ms per step; the Helmholtz NTK fit and Deep Ritz are
   examples_torch/31's and /23's own ``main()``;
11. the model options (``phase_model_features``) through the public
   Solver at their sources' widths, steps and batches: examples/07's
   oscillator system and tests/test_wave_second_ic.py's wave (plain
   chains) and examples/14 and /15 (periodic) and /21 (Fourier features,
   from the embedding's Taylor state): both Taylor kernels on every step;
   /16 (the modified MLP with adaptive collocation), /30 (branches) and
   /32 (adaptive activations), which take the plain traversal; each holds its source's bound, each
   predict of an embedded model is one MLP launch, and ``torch.profiler``
   over replays of each arm's Adam step gives its device ops and busy ms;
   each example arm runs its file's own ``main()`` (examples_torch/07,
   /14, /15, /21, /16, /30, /32) and adds its measurements after it;
12. ensembles (``phase_ensembles``, ``Solver(n_models=K)``) through the
   public Solver: examples_torch/08's ``main()`` (K = 8, 500 Adam steps at
   batch 400) with its bounds (mean max error < 0.05, std mean < 0.05),
   tests/test_ensemble.py's L-BFGS polish (K = 3, each member's max error
   < 0.02, the loss below half Adam's) and tests/test_gauss_newton.py's
   per-member LM (K = 2, state (2, 2)); one forward and one backward
   launch a replayed Adam step whatever K, 1 + trials a L-BFGS step, 50
   tangents a LM step, one MLP launch a predict, ``predict_all`` and
   ``predict_std``; then examples/08's configuration at K = 1 and 8 and
   the 64-wide fit at K = 1 and 4, in turns: it/s, device ops and busy ms
   a replayed step;
13. the symbolic layer and the separable model (``phase_symbolic``)
   through the public Solver at the examples' widths, budgets and bounds:
   examples/17 (``laplace`` in 3D, 2,500 steps at 2,048 Halton points, max
   error < 0.05; ``predict_grad`` at 10,000 points, one Taylor forward
   launch a call, against the analytic gradient), /22 (a ``Field``,
   10,000 + 20,000 steps at 256, rel_s < 0.06 and err_u < 0.005), /24
   (``laplace`` on the L-shape, rel < 0.03), whose planned chains launch
   both Taylor kernels every step; the separable /26 (Poisson 3D on a 32^3
   grid, rel < 0.02; ``predict_grid`` on 65^3 timed against ``predict`` of
   the same 274,625 points and held equal to it), /27 (wave 2+1D, rel <
   0.05) and /28 (causal Allen-Cahn, three stages of 4,000 steps in one
   graph, rels[0] < 0.05, rels[-1] < 0.15), which launch none; and
   tests/test_dtype.py's ODE in bfloat16 (max error < 0.2, float32
   results).  Each example arm runs its file's own ``main()``
   (examples_torch/17, /22, /24, /26, /27, /28) and prints it/s, points/s
   and, from ``torch.profiler`` over 5 replays of its step's graph, device
   ops, busy ms and Taylor launches a step;
14. scale-out and serving (``phase_scale_out``): tests/test_flax_adapter.py's
   ODE with a torch twin of its net through ``module_model`` (500 Adam
   steps at batch 400, max error < 0.08; no Taylor kernel); ``w1``
   exported (``Solver.export``, with and without ``with_grad``) and served
   by a child process that imports torch alone at 1, 1,000 and 1,048,576
   points, held to ``predict`` / ``predict_grad`` within rtol / atol 2e-5
   (export, load and serve ms); ``w1`` and the wide fit with
   ``mesh=make_mesh()`` (one rank over NCCL) in turns with the same fits
   without a mesh, held to the graph-vs-eager bounds (bitwise equality
   reported), one Taylor forward and backward a replayed step
   (``torch.profiler``) and one all-reduce issued a captured step
   (``Shards.collectives``: NCCL launches no kernel for one rank);
   examples/08 (K = 8) on a ``(1, 1)`` ``models x data`` mesh with its
   bounds; the README ladder on the mesh (phase 9's bounds, 50 tangents a
   LM step); examples/28's first stage (causal training of a separable
   model) on the mesh in turns with the fit without one, its losses
   bitwise equal and two all-reduces a captured step, one more than
   without the causal term (the slice means');
15. the port's examples (``phase_examples``): each file of
   ``examples_torch/`` that no arm of phases 10-13 runs, through its own
   ``main()`` on the card, in the order 01-05, 10, 29, 11, 13, 06, 25, 20,
   19, 18, 09, 12 (``EXAMPLE_ROUTES``), at its JAX example's budget, held
   to its own asserts (09's seed-0 claim, which pydens_tpu meets on 7 of
   24 seeds, is reported when it misses, its residuals held to
   pydens_tpu's worst seed instead: ``_ex09_claim``); each fit held to its
   route (one Taylor forward and backward a step on 01-05, 10, 18, 19 and
   29, a second forward on 09's adaptive steps, 50 tangents a LM step on
   29, no Taylor launch on 06, 11, 12, 13, 20 and 25), each predict one
   MLP launch where the chain is in the kernel's scope, each solver's
   chain the one phase 3 checks; one JSON line an example with its
   numbers, the rate of each fit (it/s over the whole fit, capture
   included), its seconds,
   its launches and, from ``torch.profiler`` over 5 replays, the device
   ops and busy ms of its Adam step (and of 29's LM step).  18's ranks
   run in their own processes (one a card, NCCL), which report their
   launches and steps;
16. the port's tutorial notebooks (``phase_notebooks``): every code cell
   of tutorials_torch/1_solving_pdes.ipynb and 2_torch_examples.ipynb
   verbatim on the card (``DEVICE = None``), at their own budgets, with
   every inline assert, every kernel's plain version refused; each fit
   held to its route (one Taylor forward and backward a step, two
   forwards on the adaptive step, where the solver's chain takes the
   kernels; none on the plain traversal and the separable grid), each
   model call and ``predict`` one MLP launch where the chain is in the
   kernel's scope, and ``solver.ctx.run(solver.model, xs)`` against
   ``solver.predict(xs)`` (1e-6, bitwise equality reported); one JSON
   line a notebook with its seconds, each fit's it/s, its launches and
   the numbers it printed.

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
phase 10 asserts that each solver's chain is the one checked), phase 11's
chains at their batches, the embedded ones (in_dim 3, 5, 21 and 65, out_dim
2 and 3) from a Taylor state as their embedding gives it, and the MLP kernel
at the embedded widths of its predicts (``FEATURE_CHAINS``; phase 11
asserts each solver's chain), the Taylor kernels and the tangent kernel
from an input state at the chain of portbench's ``nls-raissi`` cell
(``NLS_CHAIN``: 4 x 100, 4 streams, 20,000 points) and the tangent kernel
from the embedded chains' states at their first batch, the MLP
kernel at ``w3``'s layout on 1,024 points, and the tangent kernel
(``taylor_jvp_kernel``, Levenberg-Marquardt's J v) on the README chain at 1,024 points, the 64-wide chain
and its 6-stream closure at 65,537, the ODE finisher's chain and the
128-wide chain at 65,537 (each with its points a tile, blocks per SM and
shared memory a block), and the member axis of the four kernels
(``MEMBER_ROWS``: examples/08's chain at 400 points and the MLP at 10,000
for K = 1, 3 and 8, the 64-wide chain at 65,537 points for K = 4), each
member's slice against a single launch on its weights, and phase 13's
chains (``SYMBOLIC_CHAINS``: examples/17's 3D Laplacian at 2,048 points
and its first-order ``predict_grad`` plan at 10,000, examples/22's chain
at 256, examples/24's at 1,024; the MLP at their predicts), and phase
15's (``EXAMPLE_CHAINS``: the chains of examples_torch/10, /18, /20 and
/29 at their batches, the tangent kernel at 29's 512 LM points, the MLP at each
example's predict points).

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

``--states-turns`` runs phases 1 and 2, then ``states_turns``: the Taylor
forward that keeps the states its backward reads against the one that
keeps none, and the backward from those states against the one that
recomputes them, in turns, with each kernel's blocks an SM from the
occupancy calculator; then ``states_memory``, the peak device memory of
64-wide Adam and LM fits through ``Solver`` up to 1,048,576 points and
K = 4, keeping the states and recomputing them.

Bounds: the least time the card could take for a kernel's work, the larger
of its FMAs (2 FLOPs each) over the H100 SXM's 67 TFLOP/s f32 peak and its
bytes (each input read once, each output written once) over 3.35 TB/s; the
Taylor forward counts the products of all its streams, the backward twice
that (a fit's backward reads the forward's states; the recompute of a
direct call without them is not counted), the tangent kernel three times
that.
"""

import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]
HEAT_CLOSURE = [(0,), (1,), (2,), (0, 0), (1, 1)]   # 2D + t: 6 streams
NLS_CLOSURE = [(0,), (1,), (0, 0)]   # u_t and u_xx in 1D + t: 4 streams
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
    """Bounds of the Taylor forward (the products of all streams; x, or the
    input state, and the weights in, the streams out), backward (twice the
    products; x, the weights and the cotangent in, dW and dx out) and
    tangent (three times
    the products: the primal, tangent x W and state x tangent W; x, the
    weights and their tangent in, the streams and their tangent out)."""
    fmas = n * plan.n_streams * _products(plan.ops)
    streams = n * plan.n_streams * plan.out_dim
    inputs = math.prod(plan.input_shape(n))
    fwd_bytes = 4 * (inputs + plan.n_params + streams)
    bwd_bytes = fwd_bytes + 4 * (plan.n_params + inputs)
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


def _taylor_case(layout, features, act, n, seed, closure, in_dim,
                 input_state=False):
    """The plan, packed weights and input of one kernel check: ``n`` points
    in [0, 1), or with ``input_state`` an embedding's Taylor state
    ``(n, n_streams, in_dim)`` drawn in [-1, 1), every first- and
    second-order tap non-zero (an embedding's (x, x) taps are)."""
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_taylor as ft
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    plan = ft.TaylorPlan(net.tokens, net.activations, closure,
                         net.layer_shapes, in_dim, input_state=input_state)
    with torch.no_grad():
        packed = ft.pack_weights(net.params(), net.layer_names)
    x = torch.rand(plan.input_shape(n), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    if input_state:
        x = 2.0 * x - 1.0
    return plan, packed, x


def check_taylor(features, n, seed=0, reps=0, closure=POISSON_CLOSURE,
                 in_dim=2, memory=False, layout="fa fa fa f", act="Tanh",
                 input_state=False):
    """Forward and backward kernels against the plain autograd path, as a
    fit runs them: the forward keeping its states (bitwise the streams of
    one keeping none) and the backward reading them (``bwd``), held to the
    plain twin, bitwise the backward that recomputes the states
    (``bwd_recompute``, timed beside it) and bitwise repeatable; with
    ``memory``, each backward's peak device memory beyond its inputs.  With
    ``input_state`` the chain starts from an embedding's Taylor state
    (``_taylor_case``), and the backward without the state's cotangent (a
    fit's: ``input_grad=False``) gives the same weights' gradient bits."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, packed, x = _taylor_case(layout, features, act, n, seed, closure,
                                   in_dim, input_state)
    out, states = ft.fused_taylor_forward(packed, x, plan, keep_states=True)
    ref = ft.fused_taylor_forward_plain(packed, x, plan)
    sync()
    torch.testing.assert_close(out, ref, **VALUE_TOL)
    assert torch.equal(out, ft.fused_taylor_forward(packed, x, plan)), \
        "forward keeping its states differs from one keeping none"
    fwd_err = max_err(out, ref)
    g = 2.0 * ref / ref.numel()   # cotangent of mean(out ** 2)
    del out
    peaks = {}
    grads = {}
    for path, given in (("states", states), ("recompute", None)):
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads[path] = ft.fused_taylor_backward(packed, x, g, plan, given)
        sync()
        peaks[path] = torch.cuda.max_memory_allocated() - base
    dp, dx = grads["states"]
    rdp, rdx = ft.fused_taylor_backward_plain(packed, x, g, plan)
    sync()
    torch.testing.assert_close(dp, rdp, **GRAD_TOL)
    torch.testing.assert_close(dx, rdx, **GRAD_TOL)
    cdp, cdx = grads["recompute"]
    assert torch.equal(dp, cdp) and torch.equal(dx, cdx), \
        "backward from the states differs from the recompute"
    dp2, dx2 = ft.fused_taylor_backward(packed, x, g, plan, states)
    sync()
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2), \
        "backward not bitwise repeatable"
    if input_state:
        for given in (states, None):
            dp3, dx3 = ft.fused_taylor_backward(packed, x, g, plan, given,
                                                input_grad=False)
            sync()
            assert dx3 is None and torch.equal(dp, dp3), \
                "backward without the state's cotangent differs"
    errs = {"fwd": fwd_err, "bwd": max(max_err(dp, rdp), max_err(dx, rdx))}
    bounds = taylor_bounds(plan, n)
    times = {}
    if reps:
        times = timed_pair(
            "fwd", lambda: ft.fused_taylor_forward(packed, x, plan,
                                                   keep_states=True),
            lambda: ft.fused_taylor_forward_plain(packed, x, plan), reps)
        times.update(timed_pair(
            "bwd", lambda: ft.fused_taylor_backward(packed, x, g, plan,
                                                    states),
            lambda: ft.fused_taylor_backward_plain(packed, x, g, plan), reps))
        # The direct calls' paths, timed in turns with the fit's.
        times.update(timed_pair(
            "fwd_no_states", lambda: ft.fused_taylor_forward(packed, x, plan),
            lambda: ft.fused_taylor_forward(packed, x, plan,
                                            keep_states=True), reps))
        times.update(timed_pair(
            "bwd_recompute", lambda: ft.fused_taylor_backward(packed, x, g,
                                                              plan),
            lambda: ft.fused_taylor_backward(packed, x, g, plan, states),
            reps))
        del times["fwd_no_states_plain"], times["bwd_recompute_plain"]
    times["input_state"] = input_state
    mem = ""
    if memory:
        _, save_f, part_f = plan.backward_workspace(
            n, torch.cuda.get_device_properties(0).multi_processor_count)
        mem = (f", backward peak memory beyond its inputs from the states "
               f"{peaks['states'] / 2**20:.2f} MiB, recomputing "
               f"{peaks['recompute'] / 2**20:.2f} MiB (outputs "
               f"{(dp.numel() + dx.numel()) * 4 / 2**20:.2f} MiB, partials "
               f"{part_f * 4 / 2**20:.2f} MiB, slab {save_f * 4 / 2**20:.2f}"
               f" MiB; the states {states.numel() * 4 / 2**20:.2f} MiB)")
    log(f"taylor {layout!r} {act} {features} in_dim {in_dim} closure "
        f"{len(closure)} n={n}"
        f"{' from an input state' if input_state else ''}: "
        f"max|err| fwd {errs['fwd']:.3e} bwd {errs['bwd']:.3e}, "
        "backward from the states bitwise the recompute and repeatable"
        + (", without the state's cotangent bitwise the same dW"
           if input_state else "")
        + "".join(f", {k} {v:.4f} ms" for k, v in times.items()
                  if k != "input_state")
        + "".join(f"; {k} {work}, {_share(times[k], b)} ({by})"
                  for k, (b, by, work) in bounds.items() if k in times)
        + mem)
    for k, (b, by, _) in bounds.items():
        times[f"{k}_bound"], times[f"{k}_bound_by"] = b, by
    return errs, times


def check_taylor_jvp(features, n, reps, seed=0, closure=POISSON_CLOSURE,
                     in_dim=2, layout="fa fa fa f", act="Tanh",
                     input_state=False):
    """The tangent kernel against its plain twin (``torch.func.jvp`` of the
    plain forward) at VALUE_TOL, streams and tangent, for a seeded tangent
    of the weights, from the points or an input state (``_taylor_case``);
    both timed in turns, with the kernel's bound."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, packed, x = _taylor_case(layout, features, act, n, seed, closure,
                                   in_dim, input_state)
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
        f"{len(closure)} n={n}"
        f"{' from an input state' if input_state else ''}: max|err| "
        f"{err:.3e} (streams and tangent; "
        f"{100 * max(_tol_used(out, ref), _tol_used(tout, tref)):.1f}% of "
        f"VALUE_TOL), jvp {times['jvp']:.4f} ms (plain "
        f"{times['jvp_plain']:.4f} ms); {work}, {_share(times['jvp'], b)} "
        f"({by}); {plan.jvp_tile} points a tile, weights "
        f"{'resident' if plan.jvp_resident else 'streamed'}, {grid} blocks "
        f"of {slots} slots, {per_sm} blocks per SM on the card (occupancy "
        f"calculator; the plan sized for {plan.jvp_blocks_per_sm}), "
        f"{plan.jvp_smem} B shared memory each")
    times.update(jvp_tile=plan.jvp_tile, jvp_resident=plan.jvp_resident,
                 jvp_blocks_per_sm=per_sm, jvp_smem_bytes=plan.jvp_smem,
                 input_state=input_state)
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


# The member axis (Solver(n_models=K)): examples/08's chain at its batch
# for K = 1, 3 and 8 (the MLP at its predict-sized 10,000 points), and the
# 64-wide chain at 65,537 points for K = 4.  Keyed "<chain>_k<K>".
EX08_CHAIN = dict(layout="fafaf", features=[12, 10, 1], act="Tanh",
                  in_dim=1, closure=[(0,)])
MEMBER_ROWS = {
    **{f"ex08_k{k}": (EX08_CHAIN, 400, 10_000, k) for k in (1, 3, 8)},
    "wide_k4": (dict(layout="fa fa fa f", features=[64, 64, 64, 1],
                     act="Tanh", in_dim=2, closure=POISSON_CLOSURE),
                65537, None, 4),
}


def _member_weights(chain, n_members, seed=0):
    """``(plan, mlp plan or None, (K, P) packed weights)``: one seeded
    network a member."""
    from pydens_tpu_torch.models.layout import make_layout_network
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    dev = torch.device("cuda")
    packs = []
    for k in range(n_members):
        net = make_layout_network(chain["layout"], chain["features"],
                                  chain["act"], in_dim=chain["in_dim"],
                                  device=dev)
        net.reset_parameters(torch.Generator().manual_seed(seed + k))
        with torch.no_grad():
            packs.append(ft.pack_weights(net.params(), net.layer_names))
    plan = ft.TaylorPlan(net.tokens, net.activations, chain["closure"],
                         net.layer_shapes, chain["in_dim"])
    mlp = fm.MlpPlan(net.tokens, net.activations, net.layer_shapes,
                     chain["in_dim"])
    return plan, mlp, torch.stack(packs)


def check_members(chain, n, mlp_n, n_members, reps):
    """The member-axis launches of the forward, backward, tangent and (with
    ``mlp_n``) MLP kernels on ``n_members`` members' ``(K, P)`` weights and
    shared points, each against its plain version (values VALUE_TOL,
    gradients GRAD_TOL; the backward reads the forward's states, as a fit
    does, bitwise repeatable and bitwise the recompute), each member's
    slice against a single-member launch on its weights (bit for bit where
    the blocks a member are the single model's, else at the tolerances),
    and timed in turns with the plain version; bounds ``taylor_bounds`` /
    ``mlp_bound`` times K.  K = 1 launches the single model's grid."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    plan, mplan, packed = _member_weights(chain, n_members)
    dev = packed.device
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(dev).manual_seed(3)
    x = torch.rand((n, chain["in_dim"]), device=dev, generator=gen)
    v = torch.randn(packed.shape, device=dev, generator=gen)
    out, states = ft.fused_taylor_forward(packed, x, plan, keep_states=True)
    ref = ft.fused_taylor_forward_plain(packed, x, plan)
    sync()
    torch.testing.assert_close(out, ref, **VALUE_TOL)
    g = 2.0 * ref / ref.numel()
    dp, dx = ft.fused_taylor_backward(packed, x, g, plan, states)
    rdp, rdx = ft.fused_taylor_backward_plain(packed, x, g, plan)
    dp2, dx2 = ft.fused_taylor_backward(packed, x, g, plan, states)
    cdp, cdx = ft.fused_taylor_backward(packed, x, g, plan)
    sync()
    torch.testing.assert_close(dp, rdp, **GRAD_TOL)
    torch.testing.assert_close(dx, rdx, **GRAD_TOL)
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2), \
        "member-axis backward not bitwise repeatable"
    assert torch.equal(dp, cdp) and torch.equal(dx, cdx), \
        "member-axis backward from the states differs from the recompute"
    sv, tv = ft.fused_taylor_jvp(packed, x, v, plan)
    rsv, rtv = ft.fused_taylor_jvp_plain(packed, x, v, plan)
    sync()
    torch.testing.assert_close(sv, rsv, **VALUE_TOL)
    torch.testing.assert_close(tv, rtv, **VALUE_TOL)
    grid = plan.launch_shape(n, sm, 3, n_members)[0]
    same_grid = grid == plan.launch_shape(n, sm, 3)[0]
    if n_members == 1:
        for n_bufs in (2, 3):
            assert plan.launch_shape(n, sm, n_bufs, 1) == \
                plan.launch_shape(n, sm, n_bufs)
    for k in range(n_members):
        one = packed[k].contiguous()
        assert torch.equal(out[k], ft.fused_taylor_forward(one, x, plan))
        s1, t1 = ft.fused_taylor_jvp(one, x, v[k].contiguous(), plan)
        assert torch.equal(sv[k], s1) and torch.equal(tv[k], t1)
        d1, _ = ft.fused_taylor_backward(one, x, g[k].contiguous(), plan)
        if same_grid:
            assert torch.equal(dp[k], d1), f"member {k}: backward differs"
        else:
            torch.testing.assert_close(dp[k], d1, **GRAD_TOL)
    errs = {"fwd": max_err(out, ref),
            "bwd": max(max_err(dp, rdp), max_err(dx, rdx)),
            "jvp": max(max_err(sv, rsv), max_err(tv, rtv))}
    times = timed_pair(
        "fwd", lambda: ft.fused_taylor_forward(packed, x, plan,
                                               keep_states=True),
        lambda: ft.fused_taylor_forward_plain(packed, x, plan), reps)
    times.update(timed_pair(
        "bwd", lambda: ft.fused_taylor_backward(packed, x, g, plan, states),
        lambda: ft.fused_taylor_backward_plain(packed, x, g, plan), reps))
    times.update(timed_pair(
        "jvp", lambda: ft.fused_taylor_jvp(packed, x, v, plan),
        lambda: ft.fused_taylor_jvp_plain(packed, x, v, plan), reps))
    bounds = {k: (b * n_members, by) for k, (b, by, _)
              in taylor_bounds(plan, n).items()}
    if mlp_n:
        xm = torch.randn((mlp_n, chain["in_dim"]), device=dev, generator=gen)
        with torch.no_grad():
            mo = fm.fused_mlp_forward(packed, xm, mplan)
            mr = fm.fused_mlp_forward_plain(packed, xm, mplan)
            sync()
            torch.testing.assert_close(mo, mr, **VALUE_TOL)
            for k in range(n_members):
                assert torch.equal(mo[k], fm.fused_mlp_forward(
                    packed[k].contiguous(), xm, mplan))
            errs["mlp"] = max_err(mo, mr)
            times.update(timed_pair(
                "mlp", lambda: fm.fused_mlp_forward(packed, xm, mplan),
                lambda: fm.fused_mlp_forward_plain(packed, xm, mplan), reps))
        b, by, _ = mlp_bound(mplan, mlp_n)
        bounds["mlp"] = (b * n_members, by)
    log(f"member axis K={n_members} {chain['layout']!r} {chain['features']} "
        f"n={n}{f', mlp n={mlp_n}' if mlp_n else ''}: {grid} blocks a "
        f"member ({'as' if same_grid else 'fewer than'} one model), each "
        "member's slice equal to its single launch; "
        + ", ".join(f"{k} max|err| {e:.3e}" for k, e in errs.items()) + "; "
        + ", ".join(f"{k} {times[k]:.4f} ms (plain {times[k + '_plain']:.4f})"
                    f", {_share(times[k], bounds[k][0])} ({bounds[k][1]})"
                    for k in bounds))
    for k, (b, by) in bounds.items():
        times[f"{k}_bound"], times[f"{k}_bound_by"] = b, by
    times["grid_per_member"] = grid
    return errs, times


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
    # Phase 11's chains: two outputs, the second-IC wave, and the embedded
    # ones from their embedding's Taylor state at their fits' batches.
    tut_taylor.update({f"p11_{c}_n{n}": check_taylor(n=n, reps=200, **chain)
                       for c, (chain, counts, _)
                       in FEATURE_CHAINS.items() for n in counts})
    # Phase 13's chains: examples/17's 3D Laplacian (7 streams) and its
    # predict_grad plan (first-order streams only), examples/22 and /24.
    tut_taylor.update({f"p13_{c}_n{n}": check_taylor(n=n, reps=200, **chain)
                       for c, (chain, counts, _)
                       in SYMBOLIC_CHAINS.items() for n in counts})
    # The tangent kernel (Levenberg-Marquardt's J v): the README chain at
    # the finishers' 1,024 points, the 64-wide chain and the 6-stream
    # closure, the ODE finisher's chain, and the 128-wide chain of phase
    # 9's LM arm; "readme_n1024" heads the JSON line.
    jvp = {tag: check_taylor_jvp(**case) for tag, case in JVP_SHAPES.items()}
    jvp["p15_ex29_n512"] = check_taylor_jvp(**EX29_JVP)
    # The kernels from an input state at the nls cell's shape, and the
    # tangent kernel from the embedded chains' states at their first batch.
    tut_taylor["nls_n20000"] = check_taylor(n=NLS_POINTS, reps=20,
                                            memory=True, **NLS_CHAIN)
    jvp["nls_n20000"] = check_taylor_jvp(n=NLS_POINTS, reps=10, **NLS_CHAIN)
    jvp.update({f"p11_{c}_n{counts[0]}": check_taylor_jvp(
        n=counts[0], reps=50, **chain)
        for c, (chain, counts, _) in FEATURE_CHAINS.items()
        if chain.get("input_state")})
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
    # Phase 13's predicts.
    tut_mlp.update({f"p13_{c}_n{n}": check_mlp(
        chain["layout"], chain["features"], chain["in_dim"], n, reps=200,
        act=chain["act"])
        for c, (chain, _, predicts) in SYMBOLIC_CHAINS.items()
        for n in predicts})
    # Phase 15's chains and predicts (the examples').
    tut_taylor.update({f"p15_{c}_n{n}": check_taylor(n=n, reps=50, **chain)
                       for c, (chain, counts, _)
                       in EXAMPLE_CHAINS.items() for n in counts})
    tut_mlp.update({f"p15_{c}_n{n}": check_mlp(
        chain["layout"], chain["features"], chain["in_dim"], n, reps=50,
        act=chain["act"])
        for c, (chain, _, predicts) in EXAMPLE_CHAINS.items()
        for n in predicts})
    # Phase 11's predicts, the embedded ones at their embedded widths.
    tut_mlp.update({f"p11_{c}_n{n}": check_mlp(
        chain["layout"], chain["features"], chain["in_dim"], n,
        reps=10 if n > 100_000 else 200, act=chain["act"])
        for c, (chain, _, predicts) in FEATURE_CHAINS.items()
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
    members = {tag: check_members(chain, n, mlp_n, k,
                                  reps=10 if n > 10_000 else 100)
               for tag, (chain, n, mlp_n, k) in MEMBER_ROWS.items()}
    sync()
    return taylor, tut_taylor, mlp, tut_mlp, jvp, members


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
    device tensor and the kernel alone on the embedded points (CUDA
    events; the points themselves where the model does not embed).
    Asserts one MLP launch per ``Solver.predict`` and the kernel within
    VALUE_TOL of its plain version."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops.fused_taylor import pack_weights
    from pydens_tpu_torch.utils.inputs import normalize_inputs
    model = solver.model
    before = fm.fused_mlp_forward.launches
    u = solver.predict(grid)
    assert fm.fused_mlp_forward.launches - before == 1
    assert u.shape[0] == grid.shape[0] and np.isfinite(u).all()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        solver.predict(grid)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    split = {}
    t0 = time.perf_counter()
    xn = normalize_inputs((grid,), model.total)
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
    plain_fn = _plain_version(fm, "fused_mlp_forward_plain")
    with torch.no_grad():
        packed = pack_weights(model.params["net"], model.net.dense_names)
        e = model._embed(x).contiguous()
        kernel = fm.fused_mlp_forward(packed, e, plan)
        plain = plain_fn(packed, e, plan)
        sync()
        torch.testing.assert_close(kernel, plain, **VALUE_TOL)
        apply_ms = time_ms(lambda: model.predict_apply(model.params, x), 20)
        times = timed_pair(
            "kernel", lambda: fm.fused_mlp_forward(packed, e, plan),
            lambda: plain_fn(packed, e, plan), 20)
    bound_ms, by, _ = mlp_bound(plan, e.shape[0])
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
    return dict(points=grid.shape[0], predict_ms=float(np.mean(walls)),
                apply_ms=apply_ms, kernel_ms=times["kernel"],
                kernel_plain_ms=times["kernel_plain"],
                kernel_bound_ms=bound_ms, **split)


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


def _finisher_launches(step, d, tag):
    """The Taylor forward, backward and tangent launches of a finisher fit
    whose tally over the fit is ``d`` (``_finisher_tally`` differences):
    those of the wrappers (eager steps and captures) and those on the
    device (eager steps and replays).  A LM or masked L-BFGS step is one
    graph; otherwise a step graph (theta and the first trial) and a trial
    graph, whose live trials agree with the host's count of trial
    replays."""
    steps = d["eager"] + d["replays"]
    per_eval = _evals(step)
    if hasattr(step.opt, "cg_iters") or step.masked:
        # The graph holds the whole step.
        return ([(d["eager"] + d["graph"]) * k for k in per_eval],
                [steps * k for k in per_eval])
    trials = d["live"]
    assert trials == (d["eager"] + d["eager_trials"] + d["replays"]
                      + d["trial_replays"]), (tag, d)
    evals = 2 * d["eager"] + d["eager_trials"]
    wrapper = [evals + 2 * d["graph"] + d["trial_graph"]] * 2 + [0]
    device = [evals + 2 * d["replays"] + d["trial_replays"]] * 2 + [0]
    assert device[0] == steps + trials, (tag, d)
    return wrapper, device


def run_finisher(solver, optimizer, niters, batch, tag, kernels=True, **kw):
    """One finisher fit through graphs on a fixed batch (``resample=False``:
    one draw of the default sampler), checked by its tallies: every step
    ran once (eagerly or replayed), each eager step and each capture
    launched the Taylor kernels as the step's design says, or never when
    the chain is outside the kernels' scope (``kernels``), and the live
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
    trials = d["live"]
    wrapper, device = _finisher_launches(step, d, tag)
    if kernels:
        assert launches == wrapper, (tag, launches, wrapper, d)
    else:
        assert launches == [0, 0, 0], (tag, launches)
        device = [0, 0, 0]
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
        f"{row['taylor_jvp_per_step']:.2f}; tally {d}"
        + ("" if kernels else " (the plain traversal: the chain is outside "
           "the kernels' scope)"))
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
    under it shows that no ``*_plain`` function ran on the path (a check
    beside it takes the plain version from ``_plain_version``)."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    names = [(ft, "fused_taylor_forward_plain"),
             (ft, "fused_taylor_backward_plain"),
             (ft, "fused_taylor_jvp_plain"), (fm, "fused_mlp_forward_plain")]
    saved = [getattr(mod, name) for mod, name in names]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran where the kernels must")
    try:
        for (mod, name), fn in zip(names, saved):
            _SET_ASIDE[(mod.__name__, name)] = fn
            setattr(mod, name, refuse)
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)
        _SET_ASIDE.clear()


_SET_ASIDE = {}   # (module, name) -> the plain version _plain_refused hides


def _plain_version(mod, name):
    """A kernel's plain version, also while ``_plain_refused`` hides it
    (for a comparison beside the path's counted launches)."""
    return _SET_ASIDE.get((mod.__name__, name), getattr(mod, name))


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
# and the largest mean |residual| of examples/09's adaptive and uniform
# fits.  The reference misses the example's own claim (adaptive < 0.6 x
# uniform) on these medians: 0.1998 against 0.6 x 0.1639.
ADAPTIVE_JAX = dict(median=0.1998, max=0.7611)
UNIFORM_JAX = dict(median=0.1639, max=0.3323)
# 3x pydens_tpu's median and max error (BENCHMARKS.md:740: 0.026, 0.069).
RBA_BOUNDS = dict(median=0.078, max=0.207)
# The views of each seed's RBA fit: its initial network as drawn (0) and
# moved by one ulp in patterns 1-4 (``one_ulp``).  A fit of this stiff
# ODE now and then stalls at a max error of 0.3-0.7 where f32 rounding
# happens to send it: over 13 such views of seeds 0-5 on the card, the
# largest error of the six seeds broke RBA_BOUNDS' max in 3 views with
# nested gradients in the ansatz and in 4 with its jets, and no seed
# stalled in more than 3 of its 13 (tests/collocation_seed_study.py;
# PERF.md §6, PR 10).  So each seed is read as the median over its views.
RBA_VIEWS = tuple(range(5))
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


def one_ulp(tree, pattern):
    """Move every float32 entry of the parameter tree ``tree`` (nested
    dicts of torch tensors or of arrays) by one ulp up or down or leave
    it, each with probability 1/3, drawn from ``default_rng(pattern)``
    over the leaves in sorted key order.  Returns the new tree as numpy
    arrays: the same fit seen through another rounding."""
    rng = np.random.default_rng(pattern)

    def move(node):
        if isinstance(node, dict):
            return {key: move(node[key]) for key in sorted(node)}
        a = np.array(node.detach().cpu() if hasattr(node, "detach")
                     else node)
        if a.dtype != np.float32:
            return a
        step = rng.integers(-1, 2, size=a.shape)
        up = np.nextafter(a, np.float32(np.inf))
        down = np.nextafter(a, np.float32(-np.inf))
        return np.where(step > 0, up, np.where(step < 0, down, a))
    return move(tree)


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
    that ``phase_kernels`` holds against its plain version; an embedded
    model's plan takes the embedding's Taylor state (``input_state``)."""
    m = solver.model
    closure = m.plan_closure(solver._plan_derivs)
    got = dict(layout=m.layout, features=m.features, act=m.activation,
               in_dim=m.net.in_dim, closure=closure)
    if m._embedded:
        got["input_state"] = m._fused_taylor_plan(closure).input_state
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
    both on seeds 0-5 (RBA's each read over its views, ``RBA_VIEWS``);
    causal ``w3`` at eps 0 and 5 against its plain fit,
    then eps annealed on the cached step; grad balancing on the raw beam of
    tests/test_loss_balancing.py (order 4: the plain traversal) against
    unbalanced fits; NTK balancing on examples/31's Helmholtz equation and
    grad balancing on it through the kernels; Deep Ritz (examples/23)
    against the strong form.  The causal, beam and Helmholtz arms are
    seeded as their sources are and run twice in turns, for their rates.
    Launches per step of the new step kinds from ``torch.profiler`` over
    replays of their graphs.  Each solver's chain is one that
    ``phase_kernels`` checks (``COLLOCATION_CHAINS``)."""
    from pydens_tpu_torch import D, Solver
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
                    median_ratio=float(np.median(ratio)),
                    meets_0_6=sum(x < 0.6 for x in ratio))
    log(f"adaptive: mean |residual| {json.dumps(res)}, medians {med}; "
        f"adaptive / uniform {[round(x, 3) for x in ratio]} (the example's "
        f"0.6 held on {adaptive['meets_0_6']} of {len(ratio)} seeds; on the "
        "CPU pydens_tpu: 2 of seeds 0-5, 7 of 0-23; the port 8 of 0-23); "
        f"launches per replayed step {json.dumps(adaptive['step'])}")
    assert adaptive["step"]["taylor_fwd_kernel_per_step"] == 2.0
    assert adaptive["step"]["taylor_bwd_kernel_per_step"] == 1.0
    # The example's own claim, adaptive < 0.6 x uniform, holds for few
    # seeds in either package (on the CPU over seeds 0-23 pydens_tpu meets
    # it on 7, the port on 8, tests/collocation_seed_study.py): counted
    # here, and examples_torch/09 runs it at its seed in phase 15.
    # Asserted: the paired ratio below 1 on most seeds; the adaptive median
    # within 1.5x pydens_tpu's and the largest within 3x; the uniform
    # median within 3x pydens_tpu's.
    log(f"adaptive: the example's 0.6 on the medians: "
        f"{med['adaptive'] / med['uniform']:.3f} (pydens_tpu "
        f"{ADAPTIVE_JAX['median'] / UNIFORM_JAX['median']:.3f})")
    assert med["uniform"] < 3 * UNIFORM_JAX["median"], (med, UNIFORM_JAX)
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

    def rba_solver(arm, seed_view):
        seed, view = seed_view
        solver = _assert_chain(Solver(_stiff_ode(), seed=seed, **STIFF),
                               COLLOCATION_CHAINS["ex09"][0])
        if view:
            solver.model.load_params(dict(solver.model.params, net=one_ulp(
                solver.model.params["net"], view)))
        return solver

    start()
    rows, kept = _in_turns(
        ("rba", "fixed"), rba_solver,
        lambda arm: (dict(RBA_FIT, **(dict(rba=RBA_ETA_GAMMA)
                                      if arm == "rba" else {})), True),
        "rba", [(s, v) for s in COLLOCATION_SEEDS for v in RBA_VIEWS],
        max_error)
    read("rba")
    err = {arm: np.reshape([r["metric"] for r in rs],
                           (len(COLLOCATION_SEEDS), len(RBA_VIEWS))).tolist()
           for arm, rs in rows.items()}
    per_seed = {a: np.median(v, axis=1) for a, v in err.items()}
    rba = dict(max_error=err, it_s=rates(rows),
               seed_medians={a: v.tolist() for a, v in per_seed.items()},
               median={a: float(np.median(v)) for a, v in per_seed.items()},
               max={a: float(np.max(v)) for a, v in per_seed.items()},
               step=graph_launches(list(
                   kept["rba"]._step_cache.values())[0]),
               fixed_step=graph_launches(list(
                   kept["fixed"]._step_cache.values())[0]))
    log(f"rba: max error by seed and view {json.dumps(err)}; each seed's "
        f"median over its views {json.dumps(rba['seed_medians'])}; their "
        f"median {rba['median']}, max {rba['max']} (bounds {RBA_BOUNDS}; "
        "the unmoved views alone: median "
        f"{float(np.median([e[0] for e in err['rba']])):.4f}, max "
        f"{max(e[0] for e in err['rba']):.4f}); launches per replayed step "
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

    # NTK balancing: examples_torch/31's main(), then grad balancing on
    # its solver through the kernels.
    start()
    ex31 = _example_module("31_ntk_balanced_helmholtz")
    s, row, _ = _example_main("31_ntk_balanced_helmholtz", "kernels",
                              COLLOCATION_CHAINS["ex31"][0])
    xs_h = np.linspace(0.0, 1.0, 201, dtype=np.float32)
    grad = _assert_chain(ex31.make_solver(), COLLOCATION_CHAINS["ex31"][0])
    grad_fit = collocation_fit(grad, "helmholtz grad", True, niters=4000,
                               batch_size=1024, lr=0.002,
                               loss_terms=ex31.TERMS, loss_balancing=True)
    read("helmholtz")
    kept = {"ntk": s, "grad": grad}
    ntk = dict(max_error=dict(ntk=[row["numbers"]["err"]], grad=[float(
        np.abs(grad.predict(xs_h).ravel() - np.sin(ex31.K * xs_h)).max())]),
        it_s=dict(ntk=[row["fits"][0]["it_s"]], grad=[grad_fit["it_s"]]),
        balanced_weights={a: k.history[-1]["balanced_weights"]
                          for a, k in kept.items()},
        seconds=row["seconds"])
    for arm, k in kept.items():
        step = list(k._step_cache.values())[0]
        assert step.rebalance_eager + step.rebalance_replays == 10
        ntk[f"{arm}_rebalance_step"] = graph_launches(step, rebalance=True)
        ntk[f"{arm}_step"] = graph_launches(step)
    log(f"helmholtz balancing: {json.dumps(ntk)}")
    for arm, bwd in (("ntk", 5.0), ("grad", 2.0)):
        row = ntk[f"{arm}_rebalance_step"]
        assert row["taylor_fwd_kernel_per_step"] == 1.0, (arm, row)
        assert row["taylor_bwd_kernel_per_step"] == bwd, (arm, row)
    out["helmholtz"] = ntk
    del kept, step, s, grad
    free_card()

    # Deep Ritz: examples_torch/23's main(), variational and strong form.
    start()
    s, row, fits = _example_main("23_deep_ritz_low_regularity", "kernels",
                                 COLLOCATION_CHAINS["ex23_variational"][0])
    residual = fits[-1]["solver"]
    _assert_chain(residual, COLLOCATION_CHAINS["ex23_residual"][0])
    read("deep_ritz")
    ritz = {"rel_l2": row["numbers"], "seconds": row["seconds"],
            "adam_it_s": {}, "lbfgs": {},
            "step": _example_profile(s, "kernels", {}, "ex23")["adam_step"]}
    for arm, (adam, lbfgs) in (("variational", row["fits"][:2]),
                               ("residual", row["fits"][2:])):
        assert (adam["kind"], lbfgs["kind"]) == ("Adam", "LBFGS"), row
        ritz["adam_it_s"][arm] = adam["it_s"]
        ritz["lbfgs"][arm] = {k: lbfgs[k] for k in (
            "it_s", "final_loss", "trials_per_step")}
    log(f"deep ritz: {json.dumps(ritz)} (pydens_tpu, BENCHMARKS.md:564: "
        "0.0008 vs 0.0164)")
    out["deep_ritz"] = ritz
    del s, residual, fits
    free_card()
    log(f"collocation path launches (counters from 0 at each arm): "
        f"{json.dumps(path)}")
    return path, out


# Phase 11: the model options through the public Solver.  Each chain that a
# kernel runs on there (``_assert_chain``, ``_assert_mlp_chain``), the point
# counts its Taylor kernels take (the fits' batches) and the points of its
# predicts, held in phase 3 against the plain twins.  The embedded models'
# chains take the Taylor kernels from the embedding's Taylor state
# (``input_state``) and the MLP kernel, both at the embedded width.
FEATURE_CHAINS = {
    # examples/07: two outputs from one input, Adam at 512, L-BFGS at 2,048;
    # its predicts on 100 points and at x = 0.
    "ex07": (dict(layout="fa fa f", features=[32, 32, 2], act="Tanh",
                  in_dim=1, closure=[(0,)]), (512, 2048), (100, 1)),
    # tests/test_wave_second_ic.py: u_tt - u_xx, 1,024 then 2,048.
    "wave": (dict(layout="fa fa f", features=[32, 32, 1], act="Tanh",
                  in_dim=2, closure=POISSON_CLOSURE), (1024, 2048),
             (21, 200)),
    # examples/14: x, y periodic (5 inputs), three outputs, 6 streams;
    # Adam at 1,024 then 2,048; its 32 x 32 grid and a dense 1024 x 1024
    # one.
    "ex14": (dict(layout="fa fa fa f", features=[48, 48, 48, 3], act="Tanh",
                  in_dim=5, closure=HEAT_CLOSURE, input_state=True),
             (1024, 2048), (1024, 1_048_576)),
    # examples/15: x periodic (3 inputs), two outputs, 4 streams; Adam at
    # 1,024 then 2,048.
    "ex15": (dict(layout="fa fa fa f", features=[48, 48, 48, 2], act="Tanh",
                  in_dim=3, closure=NLS_CLOSURE, input_state=True),
             (1024, 2048), (101,)),
    # examples/21: 32 Fourier features of x (65 inputs); Adam at 512.
    "ex21": (dict(layout="fa fa f", features=[32, 32, 1], act="Tanh",
                  in_dim=65, closure=[(0,), (0, 0)], input_state=True),
             (512,), (400, 401, 1_048_576)),
    # examples/25's embedding: x with 10 harmonics (21 inputs), Adam at
    # 1,024; not an arm (its fit is item 10's causal recipe at 12,000
    # steps), checked here and run by phase 15.
    "ex25": (dict(layout="fa fa fa fa f", features=[64, 64, 64, 64, 1],
                  act="Tanh", in_dim=21, closure=NLS_CLOSURE,
                  input_state=True), (1024,), (512, 1_048_576)),
}


def _assert_mlp_chain(solver, chain):
    """The solver's network at its embedded width is ``chain``'s, which
    ``phase_kernels`` holds against its plain version, and its predict
    takes the MLP kernel."""
    m = solver.model
    got = dict(layout=m.layout, features=m.features, act=m.activation,
               in_dim=m.net.in_dim)
    want = {k: chain[k] for k in got}
    assert got == want and m._mlp_plan.in_dim == chain["in_dim"], (got,
                                                                   chain)
    return solver


def _timed_predicts(solver, calls, reps=3):
    """``[(points, output)]`` of ``solver.predict`` on each ``calls`` entry
    (a tuple of arguments), and the mean host ms of each (a synchronize
    on both sides; the first call outside the mean), with the MLP
    launches each made."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    outs, times, launches = [], [], []
    for args in calls:
        before = fm.fused_mlp_forward.launches
        outs.append(solver.predict(*args))
        launches.append(fm.fused_mlp_forward.launches - before)
        walls = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            solver.predict(*args)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        times.append(float(np.mean(walls)))
    return outs, times, launches


def _flat_params(tree):
    """A parameter tree's leaves, in key order, as one float64 vector."""
    if isinstance(tree, dict):
        return np.concatenate([_flat_params(tree[k]) for k in sorted(tree)]
                              or [np.zeros(0)])
    return tree.detach().double().reshape(-1).cpu().numpy()


class _Arm:
    """One arm of phase 11 as its loop sees it: the solver it fits (kept
    for its loss history) and the launch counts, read by ``done`` where
    the arm's path ends, before any timing beside it."""

    def __init__(self, counters):
        self.counters, self.solver, self.launches = counters, None, None
        self.theta0 = None

    def fit(self, solver):
        self.solver = solver
        self.theta0 = _flat_params(solver.model.params)
        return solver

    def example(self, name, route, chain=None):
        """examples_torch/<name>'s main() (``_example_main``): its solver
        is the arm's, with the parameters it started from."""
        solver, row, fits = _example_main(name, route, chain)
        self.solver = solver
        self.theta0 = next(f["theta0"] for f in fits if f["solver"] is solver)
        return solver, row

    def done(self):
        self.launches = {c.__name__: c.launches for c in self.counters}

    def step(self, kernels):
        """``torch.profiler`` over replays of the arm's Adam step."""
        return graph_launches(list(self.solver._step_cache.values())[0],
                              kernels=kernels)

    def predicts(self, calls, embedded):
        """Each predict is one MLP launch where the chain is in the
        kernel's scope (every embedded model here), none otherwise."""
        outs, times, launches = _timed_predicts(self.solver, calls)
        want = int(self.solver.model._mlp_plan is not None)
        assert want or not embedded, "an embedded predict without the kernel"
        assert launches == [want] * len(calls), launches
        return outs, dict(predict_ms=times, mlp_launches=launches)


def _arm_ex07(arm):
    """examples_torch/07: the oscillator system, [32, 32, 2], vector IC,
    Adam then L-BFGS through the Taylor kernels."""
    s, row = arm.example("07_system_of_equations", "kernels",
                         FEATURE_CHAINS["ex07"][0])
    assert s._plan_ok and s.model._fused_taylor_plan(
        FEATURE_CHAINS["ex07"][0]["closure"]) is not None
    row["step"] = arm.step(True)
    (_,), row_p = arm.predicts([(np.linspace(0, 1, 100),)], False)
    row.update(row_p)
    arm.done()
    log(f"features ex07 system: {json.dumps(row)}")
    assert row["step"]["taylor_fwd_kernel_per_step"] == 1.0
    return row


def _arm_wave(arm):
    """tests/test_wave_second_ic.py: u_tt = u_xx with u(x, 0) = sin(pi x)
    and u_t(x, 0) = 0."""
    from pydens_tpu_torch import D, Solver, sin

    def wave(f, x, t):
        return D(D(f, t), t) - D(D(f, x), x)

    s = arm.fit(_assert_chain(
        Solver(wave, ndims=2, seed=0,
               initial_condition=lambda x: sin(np.pi * x),
               initial_condition_t=0.0, boundary_condition=0.0,
               layout="fa fa f", features=[32, 32, 1], activation="Tanh"),
        FEATURE_CHAINS["wave"][0]))
    assert s._plan_ok
    row = dict(adam=collocation_fit(s, "wave second IC", True,
                                    niters=1500, batch_size=1024, lr=0.005))
    row["step"] = arm.step(True)
    row["lbfgs"] = run_finisher(s, "LBFGS", 100, 2048, "wave second IC")
    xs = np.linspace(0, 1, 21)
    pts = np.random.default_rng(0).uniform(0.05, 0.95, size=(200, 2))
    (edge, interior), row_p = arm.predicts([(xs, 0.0), (pts,)], False)
    row.update(row_p)
    arm.done()
    t0_pts = torch.tensor(np.stack([xs, np.zeros(21)], -1),
                          dtype=torch.float32, device=s.device)
    u_t = s.model.full_taps(s.model.params, t0_pts, [(1,)])[(1,)]
    true = np.sin(np.pi * pts[:, 0]) * np.cos(np.pi * pts[:, 1])
    row.update(ic_err=float(np.abs(edge.ravel() - np.sin(np.pi * xs)).max()),
               ic_t_err=float(u_t.detach().abs().max()),
               interior_err=float(np.abs(interior.ravel() - true).max()))
    log(f"features wave (second IC): {json.dumps(row)}")
    assert row["ic_err"] < 1e-5 and row["ic_t_err"] < 1e-4, row
    assert row["interior_err"] < 0.1, row
    assert row["step"]["taylor_fwd_kernel_per_step"] == 1.0
    return row


def _arm_ex14(arm):
    """examples_torch/14: the periodic Taylor-Green vortex, [48, 48, 48,
    3]; its predicts timed, and a dense predict at t = 0.5."""
    s, row = arm.example("14_navier_stokes_taylor_green", "kernels",
                         FEATURE_CHAINS["ex14"][0])
    assert s._plan_ok
    row["step"] = arm.step(True)
    g = np.linspace(0, 1, 33)[:-1]
    X, Y = [a.ravel() for a in np.meshgrid(g, g)]
    _, row_p = arm.predicts([(np.stack([X, Y, np.full_like(X, t)], -1),)
                             for t in (0.5, 1.0)], True)
    row.update(row_p)
    arm.done()
    row["dense"] = dense_predict(s, _grid(0.5), "ex14")
    log(f"features ex14 periodic NS: {json.dumps(row)}")
    return row


def _arm_ex15(arm):
    """examples_torch/15: the periodic Schrodinger soliton, persistent IC
    binding, [48, 48, 48, 2]; its predicts timed."""
    s, row = arm.example("15_schrodinger_soliton", "kernels",
                         FEATURE_CHAINS["ex15"][0])
    assert s._plan_ok
    row["step"] = arm.step(True)
    xs = np.linspace(-5, 5, 101)
    _, row_p = arm.predicts([(xs, np.full_like(xs, t))
                             for t in (np.pi / 4, np.pi / 2)], True)
    row.update(row_p)
    arm.done()
    log(f"features ex15 periodic NLS: {json.dumps(row)}")
    return row


def _arm_ex21(arm):
    """examples_torch/21: random Fourier features, multiscale Poisson; its
    predict timed."""
    _, row = arm.example("21_multiscale_poisson", "kernels",
                         FEATURE_CHAINS["ex21"][0])
    row["step"] = arm.step(True)
    _, row_p = arm.predicts([(np.linspace(0, 1, 400),)], True)
    row.update(row_p)
    arm.done()
    log(f"features ex21 Fourier features: {json.dumps(row)}")
    return row


def _burgers():
    """examples_torch/16's solver (the modified MLP) and its sampler."""
    return _example_module("16_burgers_shock").make_solver()


def _arm_ex16(arm):
    """examples_torch/16: Burgers, modified MLP, adaptive collocation,
    L-BFGS at 10,000 points, all on the plain traversal."""
    s, row = arm.example("16_burgers_shock", "plain")
    assert s.model._mlp_plan is None and s.model.net.tokens is None
    row["step"] = arm.step(False)
    xs = np.linspace(-1, 1, 401)
    _, row_p = arm.predicts([(xs, np.full_like(xs, t))
                             for t in (0.25, 0.5, 1.0)], False)
    row.update(row_p)
    arm.done()
    log(f"features ex16 modified MLP: {json.dumps(row)}")
    return row


def _arm_ex30(arm):
    """examples_torch/30: a branched two-head network for Lotka-Volterra,
    Adam then L-BFGS on the plain traversal."""
    s, row = arm.example("30_branched_multihead", "plain")
    assert s._plan_ok and "br1_fc1" in s.model.layer_names
    row["step"] = arm.step(False)
    _, row_p = arm.predicts([(np.linspace(0.0, 2.0, 101),)], False)
    row.update(row_p)
    arm.done()
    log(f"features ex30 branches: {json.dumps(row)}")
    return row


def _arm_ex32(arm):
    """examples_torch/32: adaptive activations on the README Poisson."""
    s, row = arm.example("32_adaptive_activation", "plain")
    assert s._plan_ok and s.model._mlp_plan is None
    assert s.model._fused_taylor_plan(POISSON_CLOSURE) is None
    row["step"] = arm.step(False)
    _, row_p = arm.predicts([(np.zeros(33), np.linspace(0, 1, 33))], False)
    row.update(row_p)
    arm.done()
    log(f"features ex32 LAAF: {json.dumps(row)}")
    return row


# Phase 11's arms in the order the phase runs them: (row key, arm).
FEATURE_ARMS = {"ex07": ("ex07_system", _arm_ex07),
                "wave": ("wave_second_ic", _arm_wave),
                "ex14": ("ex14_periodic_ns", _arm_ex14),
                "ex15": ("ex15_periodic_nls", _arm_ex15),
                "ex21": ("ex21_fourier", _arm_ex21),
                "ex16": ("ex16_modified", _arm_ex16),
                "ex30": ("ex30_branches", _arm_ex30),
                "ex32": ("ex32_laaf", _arm_ex32)}


def phase_model_features(arms=None, histories=None):
    """Phase 11, the model options through the public Solver with graphs,
    each arm at its source's widths, steps and batches, the launch
    counters set to 0 just before each arm and read where its path ends:
    examples/07's oscillator system and the second-IC wave
    (tests/test_wave_second_ic.py), whose plain chains take the Taylor
    kernels on every step; examples/14 (periodic Navier-Stokes system),
    examples/15 (periodic Schrodinger, persistent IC binding) and
    examples/21 (Fourier features), whose embedded chains take the plain
    traversal and one MLP launch a predict; examples/16 (modified MLP,
    adaptive collocation), examples/30 (branches) and examples/32
    (adaptive activations) on the plain traversal and the plain network.
    Each holds its source's bound; ``torch.profiler`` over replays of each
    arm's Adam step gives its device ops and busy ms.  ``arms`` runs a
    subset; ``histories``, a dict, takes each arm's loss history."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    counters = (ft.fused_taylor_forward, ft.fused_taylor_backward,
                fm.fused_mlp_forward)
    out, path = {}, {}
    for name, (key, run) in FEATURE_ARMS.items():
        if arms is not None and name not in arms:
            continue
        for c in counters:
            c.launches = 0
        arm = _Arm(counters)
        try:
            out[key] = run(arm)
            assert arm.launches is not None, name
            path[name] = arm.launches
        finally:
            if histories is not None and arm.solver is not None:
                histories[name] = np.asarray(arm.solver.losses, np.float64)
                histories[f"{name}_theta0"] = arm.theta0
            del arm
            free_card()
    totals = {c.__name__: sum(p[c.__name__] for p in path.values())
              for c in counters}
    log(f"model features path launches (counters from 0 at each arm): "
        f"{json.dumps(path)}; totals {totals}")
    if arms is None:
        assert all(totals.values()), totals
    return path, out


# Phase 12: ensembles.  examples/08 (ODE's configuration, K = 8) at its
# own size and bounds, tests/test_ensemble.py's L-BFGS polish and
# tests/test_gauss_newton.py's per-member LM.
EX08_FIT = dict(niters=500, batch_size=400, lr=0.02)
POLISH = dict(ndims=1, initial_condition=.5, activation="Tanh",
              layout="fafaf", features=[16, 12, 1])
ENSEMBLE_WIDE_STEPS = 50


def _ode_truth(xs):
    return np.sin(2 * np.pi * xs) + .5


def _ensemble_counters():
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    return (ft.fused_taylor_forward, ft.fused_taylor_backward,
            ft.fused_taylor_jvp, fm.fused_mlp_forward)


def _one_mlp_launch_each(solver, xs):
    """``predict``, ``predict_all`` and ``predict_std`` at ``xs``, each
    asserted to be one MLP launch (every member in it)."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    out = []
    for fn in (solver.predict, solver.predict_all, solver.predict_std):
        before = fm.fused_mlp_forward.launches
        out.append(fn(xs))
        assert fm.fused_mlp_forward.launches == before + 1, fn.__name__
    return out


def _ensemble_rate(make, n_models, fit, steps, tag):
    """A fresh solver of ``make()`` (``(equation, kwargs)``) with
    ``n_models`` members: one fit of ``steps`` (its warm-up step and its
    capture), then a timed one that replays; it/s of the second."""
    from pydens_tpu_torch import Solver
    eq, kw = make()
    solver = Solver(eq, seed=0, n_models=n_models, **kw)
    fit = dict(fit, niters=steps, progress=False)
    solver.fit(**fit)
    sync()
    t0 = time.perf_counter()
    solver.fit(**fit)
    sync()
    rate = steps / (time.perf_counter() - t0)
    assert _falling(np.asarray(solver.losses)), tag
    return solver, rate


def _nearly_free(make, fit, steps, counts, tag):
    """The same configuration at each member count of ``counts`` (two),
    in turns (a, b, b, a): it/s of each, then device ops and busy ms per
    replayed step (``step_profile``) of each; one forward and one backward
    launch a replayed step whatever K."""
    a, b = counts
    rates = {a: [], b: []}
    for k in (a, b, b, a):
        solver, rate = _ensemble_rate(make, k, fit, steps, f"{tag}_k{k}")
        rates[k].append(rate)
        del solver
        free_card()
    row = {}
    for k in counts:
        solver, _ = _ensemble_rate(make, k, fit, steps, f"{tag}_k{k}")
        prof = step_profile(solver, dict(fit), steps)
        assert_profiled_taylor(prof, f"{tag}_k{k}")
        row[f"k{k}"] = dict(it_s=rates[k], it_s_mean=float(np.mean(rates[k])),
                            **prof)
        del solver
        free_card()
    ratio = row[f"k{b}"]["device_busy_ms"] / row[f"k{a}"]["device_busy_ms"]
    row["busy_ratio"] = ratio
    row["ops_ratio"] = row[f"k{b}"]["device_ops"] / row[f"k{a}"]["device_ops"]
    log(f"ensembles {tag}: K={a} {row[f'k{a}']['it_s_mean']:.1f} it/s, "
        f"{row[f'k{a}']['device_busy_ms']:.4f} ms busy, "
        f"{row[f'k{a}']['device_ops']:.1f} ops a step; K={b} "
        f"{row[f'k{b}']['it_s_mean']:.1f} it/s, "
        f"{row[f'k{b}']['device_busy_ms']:.4f} ms busy, "
        f"{row[f'k{b}']['device_ops']:.1f} ops a step (in turns); busy "
        f"x{ratio:.3f}, ops x{row['ops_ratio']:.3f}")
    return row


def phase_ensembles():
    """Ensembles through the public Solver (``n_models``), every fit through
    graphs: examples/08 at its own size (K = 8, 500 Adam steps at batch 400,
    lr 0.02) with its own bounds; tests/test_ensemble.py's L-BFGS polish
    (K = 3) and tests/test_gauss_newton.py's per-member LM (K = 2).  The
    launch counters are set to 0 before and read after these fits and
    predicts: both Taylor kernels once a step (eager step or capture; one
    a replayed step on the card whatever K, from ``torch.profiler``), 1 +
    trials a L-BFGS step, ``cg_iters`` tangents a LM step, one MLP launch a
    predict.  Then, in turns, examples/08's configuration at K = 1 and 8
    and the 64-wide fit (batch 65,536, 50 steps) at K = 1 and 4: it/s,
    device ops and busy ms a replayed step."""
    from pydens_tpu_torch import Solver
    counters = _ensemble_counters()
    for c in counters:
        c.launches = 0
    rows = {}
    s, row, _ = _example_main("08_ensemble_uncertainty", "kernels",
                              EX08_CHAIN)
    assert s.model.n_models == 8 and s._plan_ok
    xs = np.linspace(0, 1, 100)
    mean, allp, _ = _one_mlp_launch_each(s, xs)
    assert allp.shape == (8, 100, 1)
    np.testing.assert_allclose(mean, allp.mean(0), rtol=1e-5, atol=1e-6)
    rows["ex08"] = _example_profile(s, "kernels", dict(
        row, it_s=row["fits"][0]["it_s"]), "ex08")
    log(f"ensembles ex08 (K=8): {json.dumps(rows['ex08'])}")
    del s
    free_card()

    s = Solver(_ode(), seed=0, n_models=3, **POLISH)
    s.fit(niters=600, batch_size=256, lr=0.01, progress=False)
    adam = s.losses[-1]
    rows["polish"] = run_finisher(s, "LBFGS", 120, 1024, "ensemble_lbfgs")
    per_member = s.predict_all(np.linspace(0, 1, 51))
    member_err = np.abs(per_member[..., 0] - _ode_truth(
        np.linspace(0, 1, 51))).max(1)
    assert s.losses[-1] < 0.5 * adam, (s.losses[-1], adam)
    assert (member_err < 0.02).all(), member_err
    rows["polish"].update(adam_loss=float(adam),
                          member_err=member_err.tolist())
    log(f"ensembles L-BFGS polish (K=3): Adam {adam:.4e} -> L-BFGS "
        f"{s.losses[-1]:.4e}; each member's max err {member_err}")

    lm = Solver(_ode(), seed=2, n_models=2, **ODE)
    rows["lm"] = run_finisher(lm, "LM", 20, 128, "ensemble_lm")
    assert lm.losses[-1] < lm.losses[0]
    assert tuple(lm._opt_state["damping"].shape) == (2, 2)
    path = {c.__name__: c.launches for c in counters}
    log(f"ensembles path launches (counted from 0 before the ex08 fit): "
        f"{path}")
    # Per replayed step on the card: 1 + trials a L-BFGS step, cg_iters
    # tangents a LM step.
    rows["polish_profile"] = finisher_profile(s, 1024, 5, "ensemble_lbfgs")
    rows["lm_profile"] = finisher_profile(lm, 128, 3, "ensemble_lm")
    assert rows["lm_profile"]["taylor_jvp_kernel_per_step"] == 50.0
    del s, lm
    free_card()

    def ex08():
        return _ode(), dict(ODE)

    def wide():
        return _pde(), dict(WIDE)
    rows["nearly_free_ex08"] = _nearly_free(
        ex08, dict(batch_size=400, lr=0.02), 200, (1, 8), "ex08")
    rows["nearly_free_wide"] = _nearly_free(
        wide, dict(batch_size=WIDE_BATCH), ENSEMBLE_WIDE_STEPS, (1, 4),
        "wide")
    return path, rows


# Phase 13: the symbolic layer and the separable model.  Each Taylor chain
# of the phase at the point counts its fits and predict_grad give it, and
# the MLP kernel at its predicts; phase 3 holds each against its plain
# version and phase 13 asserts that each solver's chain is the one held.
LAPLACE3 = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]
SYMBOLIC_CHAINS = {
    # examples/17: the 3D Laplacian at batch 2,048 (7 streams); the
    # example's predicts on 2,000 points and on 5 of a face.
    "ex17": (dict(layout="fa fa f", features=[48, 48, 1], act="Tanh",
                  in_dim=3, closure=LAPLACE3), (2048,), (2000, 5)),
    # examples/17's predict_grad plan: first-order streams only, 10,000.
    "ex17_grad": (dict(layout="fa fa f", features=[48, 48, 1], act="Tanh",
                       in_dim=3, closure=[(0,), (1,), (2,)]), (10000,), ()),
    # examples/22: u'' = s(x) at 256; its predicts on 100 points.
    "ex22": (dict(layout="fa fa f", features=[24, 24, 1], act="Tanh",
                  in_dim=1, closure=[(0,), (0, 0)]), (256,), (100,)),
    # examples/24: the L-shape Laplacian at 1,024; its predict on 2,000.
    "ex24": (dict(layout="fa fa fa f", features=[32, 32, 32, 1], act="Tanh",
                  in_dim=2, closure=POISSON_CLOSURE), (1024,), (2000,)),
}
EX17_GRAD_POINTS = 10000
# Phase 15's shapes that the earlier tables lack: the chains of
# examples_torch/10, /18, /20 (from its embedding's Taylor state) and /29 at
# their batches (18: one rank's 64 rows of a card's group of one), and the
# MLP kernel at each example's predict points (its embedded width for /20),
# by example: (chain, batches of the
# Taylor kernels, predict points).  01's shapes are w2's, 02's and 19's
# the README's, 03's w4's, 04's w3's, 05's w5's, 25's ex25's above.
README_CHAIN = dict(layout="fa fa fa f", features=[10, 12, 15, 1],
                    act="Tanh", in_dim=2, closure=POISSON_CLOSURE)
EXAMPLE_CHAINS = {
    "ex02": (README_CHAIN, (), (10,)),
    "ex03": (TUTORIAL_CHAINS["w4"][0], (), (100,)),
    "ex04": (TUTORIAL_CHAINS["w3"][0], (), (50, 1600)),
    "ex05": (TUTORIAL_CHAINS["w5"][0], (), (100,)),
    "ex10": (dict(layout="fa fa f", features=[24, 24, 1], act="Tanh",
                  in_dim=2, closure=[(0,), (1,), (0, 0)]), (512,), (50,)),
    "ex18": (TUTORIAL_CHAINS["w2"][0], (64,), ()),
    "ex29": (dict(layout="fa fa f", features=[24, 24, 1], act="Tanh",
                  in_dim=1, closure=[(0,), (0, 0)]), (256, 512), (501,)),
    "ex11": (dict(layout="fafaf", features=[24, 24, 1], act="Tanh",
                  in_dim=2), (), (101,)),
    "ex13": (dict(layout="fa fa f", features=[32, 32, 1], act="Tanh",
                  in_dim=2), (), (1681,)),
    "ex20": (dict(layout="fa fa fa f", features=[64, 64, 64, 1], act="Tanh",
                  in_dim=3, closure=[(0,), (1,)], input_state=True), (2048,),
             (25929,)),
    "ex19": (README_CHAIN, (), (7, 33)),
    "ex12": (dict(layout="fa fa f", features=[24, 24, 1], act="Tanh",
                  in_dim=1), (), (101,)),
}
# The chain of portbench's nls-raissi cell (Raissi et al.'s Schrodinger net
# at its published widths: x periodic, 3 inputs, 4 streams, one block an SM)
# at its 20,000 points, from the embedding's Taylor state.
NLS_CHAIN = dict(layout="fa fa fa fa f", features=[100, 100, 100, 100, 2],
                 act="Tanh", in_dim=3, closure=NLS_CLOSURE, input_state=True)
NLS_POINTS = 20000
# The tangent kernel at examples_torch/29's 512 LM points.
EX29_JVP = dict(features=[24, 24, 1], n=512, reps=100,
                closure=[(0,), (0, 0)], in_dim=1, layout="fa fa f")
EX26_GRID = 65                 # predict_grid's axis: 65 ** 3 = 274,625
EX26_DENSE = 256               # and a dense one: 256 ** 3 = 16,777,216


def _symbolic_counters():
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    return (ft.fused_taylor_forward, ft.fused_taylor_backward,
            fm.fused_mlp_forward)


def _symbolic_example(name, route, chain=None, points=None):
    """examples_torch/<name>'s main() (``_example_main``), with points/s of
    each fit: ``points`` a step (the batch, or batch ** d on a separable
    model's grid)."""
    s, row, _ = _example_main(name, route, chain)
    for f in row["fits"]:
        f.update(points_s=f["it_s"] * points, points_a_step=points)
    log(f"symbolic {name}: {json.dumps(row['numbers'])}; " + "; ".join(
        f"{f['it_s']:.1f} it/s, {f['points_s']:.4g} points/s ({points} a "
        "step)" for f in row["fits"]))
    return s, row


def _symbolic_profile(solver, row, kernels, tag):
    """``torch.profiler`` over 5 replays of the solver's last fit step's
    graph, after the arm's checks (the replays train on): device ops and
    busy ms a step, and the Taylor launches a replayed step, one of each
    for a planned chain and none on a grid (asserted)."""
    prof = graph_launches(list(solver._step_cache.values())[-1],
                          kernels=kernels)
    per_step = [prof[f"{k}_per_step"] for k in TAYLOR_KERNELS]
    assert per_step == ([1.0, 1.0] if kernels else [0.0, 0.0]), (tag, prof)
    row.update(prof)
    log(f"symbolic {tag}: a replayed step {prof['device_ops']:.1f} device "
        f"ops, {prof['device_busy_ms']:.4f} ms busy, Taylor launches "
        f"{per_step}")
    return row


def _timed_host(fn, reps=3):
    """``(result, mean host ms)`` of ``fn`` (a synchronize on both sides;
    the first call outside the mean)."""
    out = fn()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.mean(walls))


def _one_launch(counter, fn, n=1):
    """``fn()``, asserted to launch ``counter``'s kernel exactly ``n``
    times (once by default)."""
    before = counter.launches
    out = fn()
    assert counter.launches == before + n, (counter.__name__,
                                            counter.launches - before, n)
    return out


def _arm_ex17():
    """examples_torch/17: the 3D Laplacian, Halton points, 2,500 Adam steps
    at 2,048; then predict_grad at 10,000 points, one Taylor forward
    launch a call, against the analytic gradient."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    s, row = _symbolic_example("17_poisson_3d", "kernels",
                               SYMBOLIC_CHAINS["ex17"][0], 2048)
    gpts = np.random.default_rng(1).uniform(
        size=(EX17_GRAD_POINTS, 3)).astype(np.float32)
    grad, grad_ms = _timed_host(lambda: _one_launch(
        ft.fused_taylor_forward, lambda: s.predict_grad(gpts)))
    first = tuple(SYMBOLIC_CHAINS["ex17_grad"][0]["closure"])
    assert s.model._taylor_plans[first] is not None   # the kernel's scope
    sn, cs = np.sin(np.pi * gpts), np.cos(np.pi * gpts)
    true = np.pi * np.stack([cs[:, 0] * sn[:, 1] * sn[:, 2],
                             sn[:, 0] * cs[:, 1] * sn[:, 2],
                             sn[:, 0] * sn[:, 1] * cs[:, 2]], axis=1)
    assert grad.shape == (EX17_GRAD_POINTS, 3) and np.isfinite(grad).all()
    grad_err = float(np.max(np.abs(grad - true)))
    row.update(predict_grad_err_max=grad_err,
               predict_grad_rel_l2=float(np.linalg.norm(grad - true)
                                         / np.linalg.norm(true)),
               predict_grad_ms=grad_ms)
    log(f"symbolic ex17: {json.dumps(row['numbers'])}; predict_grad at "
        f"{EX17_GRAD_POINTS} points {grad_ms:.3f} ms, one Taylor forward "
        f"launch a call, max |grad - exact| {grad_err:.4f} (|grad| <= "
        f"{np.pi:.2f}), rel-L2 {row['predict_grad_rel_l2']:.4f}")
    return _symbolic_profile(s, row, True, "ex17")


def _arm_ex22():
    """examples_torch/22: the unknown source field, 10,000 + 20,000 steps
    at 256 (the data term weighted 1,000)."""
    s, row = _symbolic_example("22_unknown_field_inverse", "kernels",
                               SYMBOLIC_CHAINS["ex22"][0], 256)
    return _symbolic_profile(s, row, True, "ex22 stage 1")


def _arm_ex24():
    """examples_torch/24: laplace on the L-shape, 4,000 steps at 1,024 from
    the geometry sampler, the boundary data weighted 500."""
    s, row = _symbolic_example("24_lshape_corner_singularity", "kernels",
                               SYMBOLIC_CHAINS["ex24"][0], 1024)
    return _symbolic_profile(s, row, True, "ex24")


EX26_FIT = dict(niters=500, batch_size=32, lr=2e-3)


def _ex26_solver():
    """examples_torch/26's separable Poisson 3D solver, [32, 32, 32]."""
    s = _example_module("26_separable_poisson3d").make_solver()
    # No Taylor plan; the grid taps by forward mode on jets.
    assert not s._plan_ok and not s.model.supports_taylor
    assert s._grid_plan_ok
    return s


def _arm_ex26():
    """examples_torch/26: separable Poisson 3D, [32, 32, 32], 500 steps on
    a 32^3 grid; then predict_grid on the 65^3 grid, timed against predict
    at the same 274,625 points and held equal to it; the device time of
    each one's forward (CUDA events, on device inputs), and both calls
    again on a 256^3 grid."""
    s, row = _symbolic_example("26_separable_poisson3d", "plain",
                               points=32 ** 3)
    assert not s._plan_ok and s._grid_plan_ok
    g = np.linspace(0, 1, EX26_GRID)
    grid, grid_ms = _timed_host(lambda: s.predict_grid(g, g, g))
    pts = np.stack([c.ravel() for c in np.meshgrid(g, g, g, indexing="ij")],
                   axis=1).astype(np.float32)
    flat, flat_ms = _timed_host(lambda: s.predict(pts))
    np.testing.assert_allclose(grid.reshape(-1, 1), flat, rtol=2e-5,
                               atol=2e-5)
    params = s.model.params
    leaves = [torch.as_tensor(g, dtype=torch.float32, device="cuda").reshape(
        (1,) * k + (-1,) + (1,) * (3 - k)) for k in range(3)]
    xs = torch.as_tensor(pts, device="cuda")
    with torch.no_grad():
        grid_dev = time_ms(lambda: s.model.apply_leaves(params, leaves), 20)
        flat_dev = time_ms(lambda: s.model.predict_apply(params, xs), 20)
    del xs
    d = np.linspace(0, 1, EX26_DENSE)
    _, dense_grid_ms = _timed_host(lambda: s.predict_grid(d, d, d), reps=1)
    dense = np.stack([c.ravel() for c in np.meshgrid(d, d, d, indexing="ij")],
                     axis=1).astype(np.float32)
    _, dense_ms = _timed_host(lambda: s.predict(dense), reps=1)
    del dense
    log(f"symbolic ex26: {json.dumps(row['numbers'])}; predict_grid "
        f"{EX26_GRID}^3 {grid_ms:.3f} ms, predict of the same "
        f"{pts.shape[0]} points {flat_ms:.3f} ms (x{flat_ms / grid_ms:.2f}),"
        f" equal within rtol/atol 2e-5; their forwards on the device "
        f"{grid_dev:.4f} / {flat_dev:.4f} ms; at {EX26_DENSE}^3 "
        f"{dense_grid_ms:.2f} / {dense_ms:.2f} ms")
    row.update(predict_grid_ms=grid_ms, predict_ms=flat_ms,
               predict_points=int(pts.shape[0]),
               predict_grid_device_ms=grid_dev, predict_device_ms=flat_dev,
               dense_predict_grid_ms=dense_grid_ms, dense_predict_ms=dense_ms,
               dense_points=EX26_DENSE ** 3)
    return _symbolic_profile(s, row, False, "ex26")


def _arm_ex27():
    """examples_torch/27: separable wave 2+1D, 700 steps on a 32^3 grid,
    both initial conditions."""
    s, row = _symbolic_example("27_separable_wave2d", "plain",
                               points=32 ** 3)
    return _symbolic_profile(s, row, False, "ex27")


def _ex28(mesh=None):
    """examples_torch/28's separable Allen-Cahn solver (10 harmonics)."""
    return _example_module("28_separable_allen_cahn").make_solver(mesh=mesh)


def _arm_ex28():
    """examples_torch/28: separable Allen-Cahn, 10 harmonics, three causal
    stages (eps 1, 5, 20) of 4,000 steps on a 64^2 grid, one graph for all
    (eps is a buffer)."""
    s, row = _symbolic_example("28_separable_allen_cahn", "plain",
                               points=64 ** 2)
    eager, replays, graphs = fit_tally(s)
    assert len(s._step_cache) == 1 and graphs == 1 and eager == 1, (
        eager, replays, graphs)
    log(f"symbolic ex28: one graph for the three stages ({eager} eager "
        f"step, {replays} replays)")
    return _symbolic_profile(s, row, False, "ex28 eps 20")


def _arm_bf16():
    """tests/test_dtype.py's ODE in bfloat16 on the card: 400 steps at 400,
    max error < 0.2, float32 results."""
    from pydens_tpu_torch import Solver
    s = Solver(_ode(), seed=0, dtype=torch.bfloat16, **ODE)
    row = collocation_fit(s, "bf16", False, niters=400, batch_size=400,
                          lr=0.02)
    xs = np.linspace(0, 1, 50)
    out = {"predict": s.predict(xs), "residual": s.residual(xs),
           "predict_grad": s.predict_grad(xs)}
    assert all(v.dtype == np.float32 for v in out.values()), out
    assert s.params["net"]["fc1"]["w"].dtype == torch.bfloat16
    err = float(np.max(np.abs(out["predict"].ravel() - _ode_truth(xs))))
    log(f"symbolic bf16: {row['it_s']:.1f} it/s, max err {err:.4f} (< 0.2), "
        "float32 results")
    assert err < 0.2, err
    row["err_max"] = err
    return _symbolic_profile(s, row, False, "bf16")


SYMBOLIC_ARMS = {"ex17": _arm_ex17, "ex22": _arm_ex22, "ex24": _arm_ex24,
                 "ex26": _arm_ex26, "ex27": _arm_ex27, "ex28": _arm_ex28,
                 "bf16": _arm_bf16}


def phase_symbolic():
    """Phase 13, the symbolic layer and the separable model through the
    public Solver with graphs, at the examples' widths, budgets and bounds:
    examples/17 (``laplace`` in 3D, and ``predict_grad``), /22 (a
    ``Field``), /24 (``laplace`` on the L-shape), whose planned chains take
    both Taylor kernels on every step; the separable /26 (Poisson 3D, with
    ``predict_grid`` against ``predict``), /27 (wave 2+1D) and /28 (causal
    Allen-Cahn), which launch none; and a bfloat16 fit.  The launch
    counters are set to 0 just before the phase and read just after."""
    counters = _symbolic_counters()
    for c in counters:
        c.launches = 0
    rows = {}
    for name, arm in SYMBOLIC_ARMS.items():
        rows[name] = arm()
        free_card()
    path = {c.__name__: c.launches for c in counters}
    log(f"symbolic path launches (counted from 0 before the phase): {path}")
    assert all(path.values()), path
    return path, rows


# Phase 14: scale out and serving.  The module adapter, the serving
# artifact (held to predict in a process that imports torch alone) and
# data parallelism on a mesh of one rank over NCCL.
SERVE_BATCHES = (1, 1000, 1 << 20)
SERVE_DIR = os.path.join("build", "scale_out")
# The serving side of the export arms: torch alone (the package and jax are
# made unimportable), each artifact ``<tag>.pdtx`` loaded onto the card
# ``loads`` times and run at every batch of ``xs_<tag>.npz`` (else of
# ``xs.npz``); prints one JSON line of its timings.  Arguments: ``loads``
# and the tags (default: 2, u and du).
SERVE_CHILD = r"""
import io, json, os, sys, time
for name in ("pydens_tpu_torch", "pydens_tpu", "jax"):
    sys.modules[name] = None
import numpy as np
import torch
from torch.export.passes import move_to_device_pass

MAGIC = b"PDTTORCHEXP1"
loads = int(sys.argv[1]) if len(sys.argv) > 1 else 2
tags = sys.argv[2:] or ["u", "du"]
torch.zeros(1, device="cuda")          # the CUDA context, outside the timing
out, load_ms, serve_ms = {}, {}, {}
for tag in tags:
    own = "xs_" + tag + ".npz"
    data = np.load(own if os.path.exists(own) else "xs.npz")
    warm = torch.from_numpy(data[data.files[0]][:2]).cuda()
    # Loaded twice by default: the first load in a process also imports
    # the export machinery (its serializer, sympy).
    load_ms[tag] = []
    for _ in range(loads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = open(tag + ".pdtx", "rb").read()
        assert blob.startswith(MAGIC)
        program = torch.export.load(io.BytesIO(blob[len(MAGIC):]))
        fn = move_to_device_pass(program, "cuda").module()
        fn(warm)
        torch.cuda.synchronize()
        load_ms[tag].append((time.perf_counter() - t0) * 1e3)
    for name in data.files:
        xs = torch.from_numpy(data[name]).cuda()
        with torch.no_grad():
            res = fn(xs)
            res = res if isinstance(res, tuple) else (res,)
            for i, r in enumerate(res):
                out[f"{tag}_{name}_{i}"] = r.cpu().numpy()
            if xs.shape[0] == max(int(n[1:]) for n in data.files):
                walls = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(xs)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                serve_ms[tag] = float(np.median(walls))
np.savez("served.npz", **out)
print(json.dumps({"torch": torch.__version__,
                  "modules": sorted(n.split(".")[0] for n in sys.modules
                                    if n.startswith("pydens")
                                    and sys.modules[n] is not None),
                  "load_ms": load_ms, "serve_ms": serve_ms}))
"""


def _json_default(o):
    """numpy values in a JSON line."""
    if isinstance(o, (np.ndarray, np.generic)):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def _scale_adapter():
    """tests/test_flax_adapter.py's ODE with a torch twin of its ``Net``
    (two Tanh layers of 24) through ``module_model``: 500 Adam steps at
    batch 400, lr 0.01, max error < 0.08; no Taylor kernel (the module has
    no plan: nested ``D``), the step through graphs."""
    from pydens_tpu_torch import Solver, module_model

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(1, 24)
            self.Dense_1 = torch.nn.Linear(24, 24)
            self.Dense_2 = torch.nn.Linear(24, 1)

        def forward(self, x):
            x = torch.tanh(self.Dense_0(x))
            return self.Dense_2(torch.tanh(self.Dense_1(x)))

    s = Solver(_ode(), ndims=1, initial_condition=.5,
               model=module_model(Net()), seed=0)
    assert not s._plan_ok
    row = collocation_fit(s, "module_adapter", kernels=False, niters=500,
                          batch_size=400, lr=0.01)
    xs = np.linspace(0, 1, 50)
    err = float(np.abs(s.predict(xs).ravel() - _ode_truth(xs)).max())
    assert err < 0.08, err
    prof = graph_launches(list(s._step_cache.values())[-1], kernels=False)
    row.update(err_max=err, **prof)
    log(f"scale-out module adapter: max err {err:.5f} (< 0.08), "
        f"{row['it_s']:.1f} it/s, a replayed step {prof['device_ops']:.1f} "
        f"device ops, {prof['device_busy_ms']:.4f} ms busy")
    return row


def _scale_export():
    """``w1`` trained, exported (with and without ``with_grad``) and served
    by a process that imports torch alone, at 1, 1,000 and 1,048,576
    points: ``u`` against ``Solver.predict`` (one MLP launch each) and
    ``du`` against ``predict_grad`` (one Taylor forward launch each),
    within rtol / atol 2e-5; export and load ms, and the served ms at
    1,048,576 points against ``predict``'s (host arrays in and out) and
    ``predict_apply``'s (a device tensor in and out)."""
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    s = Solver(_pde(), seed=0, **README)
    s.fit(niters=1500, batch_size=100, progress=False)
    os.makedirs(SERVE_DIR, exist_ok=True)
    export_ms = {}
    for tag, grad in (("u", False), ("du", True)):
        sync()
        t0 = time.perf_counter()
        blob = s.export(os.path.join(SERVE_DIR, f"{tag}.pdtx"),
                        with_grad=grad)
        export_ms[tag] = (time.perf_counter() - t0) * 1e3
        log(f"scale-out export ({tag}): {len(blob)} bytes in "
            f"{export_ms[tag]:.1f} ms")
    rng = np.random.default_rng(14)
    xs = {f"n{n}": rng.uniform(size=(n, 2)).astype(np.float32)
          for n in SERVE_BATCHES}
    np.savez(os.path.join(SERVE_DIR, "xs.npz"), **xs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD],
                          cwd=SERVE_DIR, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["modules"] == [], child
    served = np.load(os.path.join(SERVE_DIR, "served.npz"))
    errs = {}
    for name, x in xs.items():
        u = _one_launch(fm.fused_mlp_forward, lambda: s.predict(x))
        du = _one_launch(ft.fused_taylor_forward, lambda: s.predict_grad(x))
        for tag, got, want in ((f"u_{name}", served[f"u_{name}_0"], u),
                               (f"du_{name}_u", served[f"du_{name}_0"], u),
                               (f"du_{name}", served[f"du_{name}_1"][..., 0],
                                du)):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                       err_msg=tag)
            errs[tag] = float(np.abs(got - want).max())
    big = xs[f"n{SERVE_BATCHES[-1]}"]
    _, predict_ms = _timed_host(lambda: s.predict(big))
    dev = torch.as_tensor(big, device="cuda")
    _, apply_ms = _timed_host(lambda: s.model.predict_apply(
        s.model.params, dev))
    _, grad_ms = _timed_host(lambda: s.predict_grad(big))
    n = SERVE_BATCHES[-1]
    row = dict(export_ms=export_ms, child=child, max_abs_err=errs,
               predict_ms=predict_ms, predict_apply_ms=apply_ms,
               predict_grad_ms=grad_ms,
               served_points_s=n / child["serve_ms"]["u"] * 1e3,
               predict_points_s=n / predict_ms * 1e3,
               predict_apply_points_s=n / apply_ms * 1e3)
    log(f"scale-out serving (torch {child['torch']} alone): load "
        f"{child['load_ms']} ms; at {n} points the artifact "
        f"{child['serve_ms']} ms (device tensors), predict {predict_ms:.3f} "
        f"ms (host arrays), predict_apply {apply_ms:.3f} ms, predict_grad "
        f"{grad_ms:.3f} ms; max |served - package| {max(errs.values()):.3e}")
    del s
    free_card()
    return row


EXPORT_BIG = ("periodic", "module")   # served at 1,048,576 points too


def _export_families():
    """``name: (equation, Solver options)``: every family whose
    ``export(with_grad=True)`` runs the model on jets
    (tests/export_families.py's, 64 wide, three hidden layers on a chain,
    a K = 4 ensemble), and examples_torch/06's custom ``Model``."""
    import importlib.util
    import pydens_tpu_torch as tpdt
    spec = importlib.util.spec_from_file_location(
        "export_families", os.path.join("tests", "export_families.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {name: (eq(tpdt), opts(tpdt)) for name, (eq, opts)
           in mod.families(width=64, depth=3, members=4).items()}
    ex06 = _example_module("06_custom_model")
    out["custom"] = (ex06.ode, dict(ndims=1, initial_condition=.5,
                                    model=ex06.ResidualMLP))
    return out


def _scale_export_families():
    """Every family of ``_export_families`` at its seeded theta (the gate
    moved off 0), exported with ``with_grad`` on the card and served by
    the torch-alone child at 1,000 points (``EXPORT_BIG`` at 1,048,576
    too): ``u`` against ``predict`` (one MLP launch where the chain is in
    the kernel's scope, else none) and ``du`` against ``predict_grad``
    (one Taylor forward launch on a chain in the Taylor kernels' scope,
    else none), within rtol / atol 2e-5 (a bfloat16 model within two
    bfloat16 ulps of the largest value, ``2 ** -7`` of it).  Each
    family's export ms and bytes; at 1,048,576 points the served ms
    (device tensors) against ``predict_grad``'s (host arrays)."""
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.ops import fused_mlp as fm
    from pydens_tpu_torch.ops import fused_taylor as ft
    folder = os.path.join(SERVE_DIR, "families")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(15)
    solvers, points, rows = {}, {}, {}
    for name, (eq, opts) in _export_families().items():
        s = Solver(eq, seed=0, **opts)
        with torch.no_grad():
            s.model.log_scale.add_(0.3)
        sync()
        t0 = time.perf_counter()
        blob = s.export(os.path.join(folder, f"{name}.pdtx"),
                        with_grad=True)
        rows[name] = dict(export_ms=(time.perf_counter() - t0) * 1e3,
                          bytes=len(blob))
        lo = np.array([d[0] for d in s.model.domain], np.float32)
        hi = np.array([d[1] for d in s.model.domain], np.float32)
        points[name] = {
            f"n{n}": (lo + (hi - lo) * rng.uniform(size=(n, len(lo))))
            .astype(np.float32)
            for n in ((1000, 1 << 20) if name in EXPORT_BIG else (1000,))}
        np.savez(os.path.join(folder, f"xs_{name}.npz"), **points[name])
        solvers[name] = s
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, "1",
                           *solvers], cwd=folder, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["modules"] == [], child
    served = np.load(os.path.join(folder, "served.npz"))
    for name, s in solvers.items():
        model, x = s.model, points[name]["n1000"]
        mlp = getattr(model, "_mlp_plan", None) is not None
        plan = getattr(model, "_fused_taylor_plan", None)
        taylor = plan is not None and plan(model.plan_closure(
            {(a,) for a in range(model.total)})) is not None
        u = _one_launch(fm.fused_mlp_forward, lambda: s.predict(x),
                        int(mlp))
        du = _one_launch(ft.fused_taylor_forward,
                         lambda: s.predict_grad(x), int(taylor))
        errs = {}
        for tag, got, want in (
                ("u", served[f"{name}_n1000_0"], u),
                ("du", served[f"{name}_n1000_1"].reshape(du.shape), du)):
            tol = (dict(rtol=0.0, atol=2.0 ** -7 * float(np.abs(want).max()))
                   if model.dtype == torch.bfloat16
                   else dict(rtol=2e-5, atol=2e-5))
            np.testing.assert_allclose(got, want, err_msg=f"{name} {tag}",
                                       **tol)
            errs[tag] = float(np.abs(got - want).max())
        rows[name].update(max_abs_err=errs, mlp_launches=int(mlp),
                          taylor_launches=int(taylor),
                          load_ms=child["load_ms"][name][0])
        if name in EXPORT_BIG:
            big = points[name][f"n{1 << 20}"]
            _, grad_ms = _timed_host(lambda: s.predict_grad(big))
            rows[name].update(served_ms=child["serve_ms"][name],
                              predict_grad_ms=grad_ms)
        log(f"scale-out export {name}: {rows[name]['bytes']} bytes in "
            f"{rows[name]['export_ms']:.1f} ms, loaded in "
            f"{rows[name]['load_ms']:.1f} ms; max |served - package| u "
            f"{errs['u']:.3e} du {errs['du']:.3e}; launches MLP {int(mlp)} "
            f"Taylor {int(taylor)}"
            + (f"; at {1 << 20} points served {rows[name]['served_ms']:.3f}"
               f" ms, predict_grad {rows[name]['predict_grad_ms']:.3f} ms"
               if name in EXPORT_BIG else ""))
    del solvers, s
    free_card()
    return rows


def _collectives_every_step(solver, steps):
    """The mesh fit's collectives, from ``Shards.collectives`` (counted at
    each eager step and capture): one all-reduce a step kind run."""
    from pydens_tpu_torch.parallel.shards import Shards
    eager, replays, graphs = fit_tally(solver)
    assert eager + replays == steps, (eager, replays, steps)
    assert Shards.collectives == eager + graphs, (Shards.collectives, eager,
                                                  graphs)
    return Shards.collectives


def _nccl_profile(solver):
    """``graph_launches`` over 5 replays of the solver's step, and the NCCL
    kernels on the device in the same kind of window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = list(solver._step_cache.values())[-1]
    row = graph_launches(step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step.index.zero_()
            step.graph.replay()
        sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    row["nccl_kernels_per_step"] = sum("nccl" in e.name.lower()
                                       for e in dev) / 5
    return row


def _scale_mesh(mesh):
    """``w1`` (1,500 steps at batch 100) and the wide fit (WIDE_STEPS at
    WIDE_BATCH) with ``mesh=make_mesh()`` (one rank, NCCL) in turns with the
    same fits without a mesh (plain, mesh, mesh, plain): the losses held to
    the graph-vs-eager bounds (rtol 1e-5 over the first 20 steps, 1e-3 at
    the end; bitwise equality reported), every step of each, one
    all-reduce issued a captured step, and from ``torch.profiler`` over
    replays one Taylor forward and one backward a replayed step, device ops
    and busy ms with and without the mesh."""
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.parallel.shards import Shards
    counters = _ensemble_counters()[:2]
    rows = {}
    for tag, make, fit in (
            ("w1", lambda m: Solver(_pde(), seed=0, mesh=m, **README),
             dict(niters=1500, batch_size=100)),
            ("wide", lambda m: Solver(_pde(), seed=0, mesh=m, **WIDE),
             dict(niters=WIDE_STEPS, batch_size=WIDE_BATCH))):
        arms = {"plain": [], "mesh": []}
        for arm in ("plain", "mesh", "mesh", "plain"):
            s = make(mesh if arm == "mesh" else None)
            before = [c.launches for c in counters]
            Shards.collectives = 0
            sync()
            t0 = time.perf_counter()
            s.fit(progress=False, **fit)
            sync()
            wall = time.perf_counter() - t0
            launches = {c.__name__: c.launches - b
                        for c, b in zip(counters, before)}
            assert_taylor_every_step(s, fit["niters"], launches)
            issued = (_collectives_every_step(s, fit["niters"])
                      if arm == "mesh" else Shards.collectives)
            assert arm == "mesh" or issued == 0
            arms[arm].append(dict(it_s=fit["niters"] / wall,
                                  losses=np.asarray(s.losses),
                                  collectives=issued))
            if len(arms[arm]) == 1:
                arms[arm][0]["profile"] = _nccl_profile(s)
                assert_profiled_taylor(arms[arm][0]["profile"], tag)
            del s
            free_card()
        a, b = arms["plain"][0]["losses"], arms["mesh"][0]["losses"]
        np.testing.assert_allclose(b[:20], a[:20], rtol=1e-5)
        np.testing.assert_allclose(b[-1], a[-1], rtol=1e-3)
        row = {arm: dict(it_s=[r["it_s"] for r in runs],
                         it_s_mean=float(np.mean([r["it_s"] for r in runs])),
                         collectives=runs[0]["collectives"],
                         final_loss=float(runs[0]["losses"][-1]),
                         **runs[0]["profile"])
               for arm, runs in arms.items()}
        row["bitwise_equal"] = bool(np.array_equal(a, b))
        row["max_rel_diff"] = float(np.max(np.abs(a - b) / np.abs(a)))
        row["busy_ratio"] = (row["mesh"]["device_busy_ms"]
                             / row["plain"]["device_busy_ms"])
        rows[tag] = row
        log(f"scale-out mesh {tag}: plain {row['plain']['it_s_mean']:.1f} "
            f"it/s, {row['plain']['device_ops']:.1f} ops, "
            f"{row['plain']['device_busy_ms']:.4f} ms busy a step; mesh "
            f"{row['mesh']['it_s_mean']:.1f} it/s, "
            f"{row['mesh']['device_ops']:.1f} ops, "
            f"{row['mesh']['device_busy_ms']:.4f} ms busy, NCCL kernels "
            f"{row['mesh']['nccl_kernels_per_step']} a replayed step, "
            f"{row['mesh']['collectives']} all-reduces issued (eager step + "
            f"capture); losses bitwise equal {row['bitwise_equal']}, max rel "
            f"diff {row['max_rel_diff']:.3e}")
    return rows


EX28_STAGE = dict(niters=4000, batch_size=64, lr=1e-3, causal=1.0,
                  chunk_size=4000)      # examples/28's first stage


def _scale_causal_separable(mesh):
    """examples/28's first stage (EX28_STAGE: 4,000 steps on a 64^2 grid,
    eps 1) with ``mesh=make_mesh()`` (one rank, NCCL) in turns with the
    same fit without a mesh (plain, mesh, mesh, plain): the losses bitwise
    equal (asserted), every step of each, and two all-reduces issued a
    captured mesh step (``Shards.collectives``), one more than the same
    mesh fit without the causal term (50 steps, one; asserted): the slice
    means' sum before the sort.  From ``torch.profiler`` over replays,
    device ops and busy ms with and without the mesh."""
    from pydens_tpu_torch.parallel.shards import Shards
    arms = {"plain": [], "mesh": []}
    for arm in ("plain", "mesh", "mesh", "plain"):
        s = _ex28(mesh if arm == "mesh" else None)
        Shards.collectives = 0
        sync()
        t0 = time.perf_counter()
        s.fit(progress=False, **EX28_STAGE)
        sync()
        wall = time.perf_counter() - t0
        eager, replays, graphs = fit_tally(s)
        assert eager + replays == EX28_STAGE["niters"], (eager, replays)
        issued = Shards.collectives
        assert issued == (2 * (eager + graphs) if arm == "mesh" else 0), (
            arm, issued, eager, graphs)
        arms[arm].append(dict(it_s=EX28_STAGE["niters"] / wall,
                              losses=np.asarray(s.losses),
                              collectives=issued))
        if len(arms[arm]) == 1:
            arms[arm][0]["profile"] = graph_launches(
                list(s._step_cache.values())[-1], kernels=False)
        del s
        free_card()
    s = _ex28(mesh)
    Shards.collectives = 0
    s.fit(progress=False, **dict(EX28_STAGE, niters=50, chunk_size=50,
                                 causal=None))
    eager, replays, graphs = fit_tally(s)
    plain_issued = Shards.collectives
    assert plain_issued == eager + graphs, (plain_issued, eager, graphs)
    del s
    free_card()
    a, b = arms["plain"][0]["losses"], arms["mesh"][0]["losses"]
    assert np.array_equal(a, b), float(np.max(np.abs(a - b) / np.abs(a)))
    row = {arm: dict(it_s=[r["it_s"] for r in runs],
                     collectives=runs[0]["collectives"],
                     final_loss=float(runs[0]["losses"][-1]),
                     **runs[0]["profile"])
           for arm, runs in arms.items()}
    row.update(bitwise_equal=True, collectives_without_causal=plain_issued,
               busy_ratio=(row["mesh"]["device_busy_ms"]
                           / row["plain"]["device_busy_ms"]))
    log(f"scale-out causal separable (examples/28 stage 1): plain "
        f"{np.mean(row['plain']['it_s']):.1f} it/s, "
        f"{row['plain']['device_ops']:.1f} ops, "
        f"{row['plain']['device_busy_ms']:.4f} ms busy a step; mesh "
        f"{np.mean(row['mesh']['it_s']):.1f} it/s, "
        f"{row['mesh']['device_ops']:.1f} ops, "
        f"{row['mesh']['device_busy_ms']:.4f} ms busy; all-reduces issued "
        f"{row['mesh']['collectives']} (eager step + capture) against "
        f"{plain_issued} without the causal term; losses bitwise equal")
    return row


def _scale_ensemble():
    """examples/08 at K = 8 (500 Adam steps at batch 400) on a (1, 1)
    ``models x data`` mesh, with its bounds (mean max error < 0.05, std
    mean < 0.05) and both Taylor kernels every step."""
    from pydens_tpu_torch import Solver, make_mesh
    counters = _ensemble_counters()[:2]
    mesh = make_mesh(shape=(1, 1), axis_names=("models", "data"))
    s = Solver(_ode(), seed=0, n_models=8, mesh=mesh, **ODE)
    assert s._shards.model_axis == "models" and s._shards.k_local == 8
    before = [c.launches for c in counters]
    s.fit(progress=False, **EX08_FIT)
    launches = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    assert_taylor_every_step(s, EX08_FIT["niters"], launches)
    xs = np.linspace(0, 1, 100)
    mean, std = s.predict(xs), s.predict_std(xs)
    err = float(np.abs(mean.ravel() - _ode_truth(xs)).max())
    assert err < 0.05 and std.mean() < 0.05, (err, std.mean())
    log(f"scale-out ex08 (K=8, models x data (1, 1)): mean max err "
        f"{err:.4f} (< 0.05), std mean {std.mean():.5f} (< 0.05)")
    del s
    free_card()
    return dict(err_max=err, std_mean=float(std.mean()))


def _scale_lm(mesh):
    """The README ladder on the mesh: Adam 1,500 at batch 100, L-BFGS 200
    and LM 50 at 1,024 fixed points (phase 9's bounds: L-BFGS below Adam,
    LM below 1.9e-5), with ``cg_iters`` tangent launches a replayed LM step
    (``finisher_profile``)."""
    from pydens_tpu_torch import Solver
    s = Solver(_pde(), seed=0, mesh=mesh, **README)
    s.fit(niters=1500, batch_size=100, progress=False)
    adam = float(s.losses[-1])
    rows = dict(lbfgs=run_finisher(s, "LBFGS", 200, 1024, "mesh_lbfgs"),
                lm=run_finisher(s, "LM", 50, 1024, "mesh_lm"))
    assert rows["lbfgs"]["final_loss"] < adam, rows
    assert rows["lm"]["final_loss"] < 1.9e-5, rows
    rows["lm_profile"] = finisher_profile(s, 1024, 3, "mesh LM")
    assert rows["lm_profile"]["taylor_jvp_kernel_per_step"] == 50.0
    log(f"scale-out README ladder on the mesh: Adam {adam:.4e}, L-BFGS "
        f"{rows['lbfgs']['final_loss']:.4e}, LM {rows['lm']['final_loss']:.4e}")
    del s
    free_card()
    return rows


def phase_scale_out():
    """Phase 14 through the public entry points (``module_model``,
    ``Solver.export``, ``load_exported``'s format, ``make_mesh``,
    ``Solver(mesh=)``): the module adapter, the serving artifact, the mesh
    fits, examples/08 on a models axis and the README ladder on the mesh.
    The launch counters are set to 0 just before and read just after.
    Every kernel's plain version raises: the artifacts' derivatives are
    written out on jets, not by a kernel's plain twin."""
    from pydens_tpu_torch import make_mesh
    from pydens_tpu_torch.parallel.mesh import destroy_local_world
    counters = _ensemble_counters()
    for c in counters:
        c.launches = 0
    rows = {}
    try:
        mesh = make_mesh()
        assert torch.distributed.get_backend() == "nccl"
        with _plain_refused():
            rows["adapter"] = _scale_adapter()
            rows["export"] = _scale_export()
            rows["export_families"] = _scale_export_families()
            rows["mesh"] = _scale_mesh(mesh)
            rows["causal_separable"] = _scale_causal_separable(mesh)
            rows["ex08_models_axis"] = _scale_ensemble()
            rows["ladder"] = _scale_lm(mesh)
    finally:
        destroy_local_world()
    path = {c.__name__: c.launches for c in counters}
    log(f"scale-out path launches (counted from 0 before the phase): {path}")
    return path, rows


# Phase 15: the port's examples (examples_torch/), each file's main() on the
# card in the order below, its own asserts the check.  Route: "kernels",
# one Taylor forward and backward a replayed Adam step (50 tangents a LM
# step on 29; the periodic chains of 20 and 25 from the embedding's Taylor
# state); "plain", no Taylor launch (an order above two or a custom body:
# the plain traversal or nested D).
EXAMPLES_DIR = "examples_torch"
EXAMPLE_ROUTES = {
    "01_simple_ode": ("kernels", TUTORIAL_CHAINS["w2"][0]),
    "02_poisson_2d": ("kernels", README_CHAIN),
    "03_parametric_family": ("kernels", TUTORIAL_CHAINS["w4"][0]),
    "04_heat_parametric": ("kernels", TUTORIAL_CHAINS["w3"][0]),
    "05_inverse_problem": ("kernels", TUTORIAL_CHAINS["w5"][0]),
    "10_data_assimilation": ("kernels", EXAMPLE_CHAINS["ex10"][0]),
    "29_eigenvalue_problem": ("kernels", EXAMPLE_CHAINS["ex29"][0]),
    "11_kdv_soliton": ("plain", EXAMPLE_CHAINS["ex11"][0]),
    "13_plate_bending": ("plain", EXAMPLE_CHAINS["ex13"][0]),
    "06_custom_model": ("plain", None),
    "25_allen_cahn": ("kernels", FEATURE_CHAINS["ex25"][0]),
    "20_causal_convection": ("kernels", EXAMPLE_CHAINS["ex20"][0]),
    "19_serving_http": ("kernels", README_CHAIN),
    "18_distributed_data_parallel": ("kernels", None),
    # The two examples that no arm of phases 10-13 runs.
    "09_adaptive_collocation": ("kernels", COLLOCATION_CHAINS["ex09"][0]),
    "12_biharmonic_beam": ("plain", EXAMPLE_CHAINS["ex12"][0]),
}
EX29_LM = dict(batch=512, steps=3)    # finisher_profile of 29's LM step


def _example_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_kind(step):
    return ("LM" if hasattr(step.opt, "cg_iters")
            else "LBFGS" if hasattr(step.opt, "linesearch") else "Adam")


@contextlib.contextmanager
def _watched_solvers(fits, predicts):
    """``Solver.fit`` of every solver and every model call while entered:
    each fit appended to ``fits`` (the solver, its parameters before its
    first watched fit, steps run, wall by the host clock between two
    synchronizes, the step tally and the finisher tally of the fit's step
    over the fit, the Taylor wrapper launches over the fit, the step),
    each model call's MLP launches (``Solver.predict`` is one) to
    ``predicts`` with whether the chain is in the kernel's scope."""
    from pydens_tpu_torch import Model, Solver
    from pydens_tpu_torch.ops import fused_mlp as fm
    counters = _finisher_counters()
    fit, forward = Solver.fit, Model.forward

    def watched_fit(self, *args, **kwargs):
        theta0 = (None if any(f["solver"] is self for f in fits)
                  else _flat_params(self.model.params))
        before, n0 = _kind_tally(self), len(self.losses)
        snap = {id(s): _finisher_tally(s) for s in self._step_cache.values()}
        launches = [c.launches for c in counters]
        sync()
        t0 = time.perf_counter()
        out = fit(self, *args, **kwargs)
        sync()
        wall = time.perf_counter() - t0
        after = _kind_tally(self)
        step = _finisher_step(self)
        fin = _finisher_tally(step)
        fin0 = snap.get(id(step), dict.fromkeys(fin, 0))
        fits.append(dict(
            solver=self, theta0=theta0, steps=len(self.losses) - n0,
            wall=wall, tally={k: after[k] - before[k] for k in after},
            finisher={k: fin[k] - fin0[k] for k in fin},
            launches=[c.launches - n for c, n in zip(counters, launches)],
            step=step, first_loss=float(self.losses[n0]),
            final_loss=float(self.losses[-1])))
        return out

    def watched_forward(self, *args, **kwargs):
        before = fm.fused_mlp_forward.launches
        out = forward(self, *args, **kwargs)
        predicts.append((fm.fused_mlp_forward.launches - before,
                         getattr(self, "_mlp_plan", None) is not None))
        return out

    Solver.fit, Model.forward = watched_fit, watched_forward
    try:
        yield
    finally:
        Solver.fit, Model.forward = fit, forward


def _example_fit_route(f, route, tag):
    """One fit of an example held to its route: every step ran once
    (eagerly or replayed, of its kind), and each eager step and each
    capture launched the Taylor kernels as the step's design says (an
    Adam step ``_kind_launches``: adaptive a second forward, a rebalance
    step its pullbacks; an L-BFGS or LM step ``_finisher_launches``), or
    never on the plain route.  Returns the Taylor launches on the device
    (eager steps and replays), per kernel."""
    d, step = f["tally"], f["step"]
    steps = (d["eager"] + d["replays"] + d["rebalance_eager"]
             + d["rebalance_replays"])
    assert steps == f["steps"], (tag, d, f["steps"])
    assert d["replays"] > 0 or d["graph"] > 0, (tag, d)
    if route == "plain":
        assert f["launches"] == [0, 0, 0], (tag, f["launches"])
        return [0, 0, 0]
    if _step_kind(step) == "Adam":
        train, rebalance = _kind_launches(step)
        wrapper = [(d["eager"] + d["graph"]) * t
                   + (d["rebalance_eager"] + d["rebalance_graph"]) * r
                   for t, r in zip(train, rebalance)] + [0]
        device = [(d["eager"] + d["replays"]) * t
                  + (d["rebalance_eager"] + d["rebalance_replays"]) * r
                  for t, r in zip(train, rebalance)] + [0]
    else:
        wrapper, device = _finisher_launches(step, f["finisher"], tag)
    assert f["launches"] == wrapper, (tag, _step_kind(step), f["launches"],
                                      wrapper, d)
    return device


def _fit_rows(fits):
    """Each watched fit's kind, steps, it/s over the whole fit (capture
    included), step tally and first and last losses (L-BFGS: its trials a
    step)."""
    return [dict(steps=f["steps"], kind=_step_kind(f["step"]),
                 it_s=f["steps"] / f["wall"], tally=f["tally"],
                 first_loss=f["first_loss"], final_loss=f["final_loss"],
                 **({"trials_per_step": f["finisher"]["live"] / f["steps"]}
                    if _step_kind(f["step"]) == "LBFGS" else {}))
            for f in fits]


def _example_main(name, route, chain, claim=None):
    """examples_torch/<name>'s main() on the card, watched: its fits held to
    the route (``_example_fit_route``), each predict one MLP launch where
    the chain is in the kernel's scope, the returned solver's chain the
    one phase 3 checks (``_assert_chain`` with a plan closure, else
    ``_assert_mlp_chain``).  An AssertionError of main() is raised, or
    with ``claim`` given to ``claim(err, fits)``, which raises it unless it
    is the one assert that ``claim`` reports, and then gives the solver and
    the numbers.  The launch counters are read before and after (callers
    set them to 0 where their path starts).  Returns the
    solver, the row (its numbers, seconds, launches, each fit's kind,
    steps, it/s over the whole fit with its capture, tally and losses, the
    Taylor launches on the device) and the watched fits."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    counters = _finisher_counters() + (fm.fused_mlp_forward,)
    mod = _example_module(name)
    fits, predicts = [], []
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    with _watched_solvers(fits, predicts):
        try:
            solver, numbers = mod.main()
        except AssertionError as err:
            if claim is None:
                raise
            solver, numbers = claim(err, fits)
    sync()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    row = dict(numbers=numbers, seconds=seconds, launches=launches)
    device = [0, 0, 0]
    for i, f in enumerate(fits):
        dev = _example_fit_route(f, route, f"{name} fit {i}")
        device = [a + b for a, b in zip(device, dev)]
    row["fits"] = _fit_rows(fits)
    row["device_launches"] = device
    assert all(n == int(in_scope) for n, in_scope in predicts), predicts
    assert all(in_scope for _, in_scope in predicts) or chain is None, (
        name, predicts)
    row["predicts"] = [n for n, _ in predicts]
    if chain is not None and "closure" in chain and route == "kernels":
        _assert_chain(solver, chain)
    elif chain is not None:
        _assert_mlp_chain(solver, chain)
    return solver, row, fits


def _example_profile(solver, route, row, name):
    """``torch.profiler`` over replays of the solver's last Adam step (the
    Taylor launches of its kind's design on the kernels' route, none on the
    plain one), and, where it has one, of its LM step."""
    adam = [s for s in solver._step_cache.values() if _step_kind(s) == "Adam"]
    prof = graph_launches(adam[-1], kernels=route == "kernels")
    per_step = [prof[f"{k}_per_step"] for k in TAYLOR_KERNELS]
    assert per_step == (list(_kind_launches(adam[-1])[0])
                        if route == "kernels" else [0.0, 0.0]), prof
    row["adam_step"] = prof
    if any(_step_kind(s) == "LM" for s in solver._step_cache.values()):
        lm = finisher_profile(solver, EX29_LM["batch"], EX29_LM["steps"],
                              f"{name} LM")
        assert lm["taylor_jvp_kernel_per_step"] == 50.0, lm
        row["lm_step"] = lm
    return row


def _ex09_claim(err, fits):
    """examples_torch/09's own assert, adaptive < 0.6 x uniform at seed 0,
    is a claim about one seed's draw: over seeds 0-23 on the CPU
    pydens_tpu meets it on 7 and the port on 8
    (``tests/collocation_seed_study.py``), and the card's seed 0 misses it
    (0.786).  A miss of that assert, and of no other, is reported: the
    example's two fits must be the uniform one and then the adaptive one,
    ``err``'s argument the residuals that their solvers give again on the
    example's 2,000 points (rtol 1e-6), and each residual is held instead
    to pydens_tpu's largest over seeds 0-5 (``UNIFORM_JAX``,
    ``ADAPTIVE_JAX``).  Any other error is raised.  Returns the adaptive
    solver and the example's numbers."""
    pools = [f["step"].options.adaptive for f in fits]
    if (pools != [None, ADAPTIVE_POOL] or len(err.args) != 1
            or not isinstance(err.args[0], tuple) or len(err.args[0]) != 2):
        raise err
    xs = np.linspace(0, 1, 2000)
    res_uniform, res_adaptive = (float(f["solver"].residual(xs).mean())
                                 for f in fits)
    if not np.allclose(err.args[0], (res_adaptive, res_uniform), rtol=1e-6,
                       atol=0):
        raise err
    ratio = res_adaptive / res_uniform
    log(f"example 09: its own assert (adaptive < 0.6x uniform at seed 0) "
        f"missed on this card: {res_adaptive:.4f} / {res_uniform:.4f} = "
        f"{ratio:.3f}; pydens_tpu meets it on 7 of seeds 0-23 on the CPU, "
        "the port on 8")
    assert res_adaptive <= ADAPTIVE_JAX["max"], (res_adaptive, ADAPTIVE_JAX)
    assert res_uniform <= UNIFORM_JAX["max"], (res_uniform, UNIFORM_JAX)
    return fits[1]["solver"], {"res_uniform": res_uniform,
                               "res_adaptive": res_adaptive, "ratio": ratio,
                               "own_assert": "missed"}


def _run_example(name, route, chain, claim=None):
    """One example of phase 15: its main() (``_example_main``), then
    ``torch.profiler`` over replays of its last Adam step (and of 29's LM
    step)."""
    solver, row, _ = _example_main(name, route, chain, claim)
    if solver is None:              # 18: the fit ran in the ranks' processes
        return row
    return _example_profile(solver, route, row, name)


def _run_example_18():
    """examples_torch/18: its ranks run in their own processes (one a card,
    NCCL), so the launches and the step tally are the first rank's, as it
    reports them: every step ran once, and each eager step and capture
    launched the Taylor forward and backward once."""
    mod = _example_module("18_distributed_data_parallel")
    t0 = time.perf_counter()
    _, result = mod.main()
    seconds = time.perf_counter() - t0
    st, tl = result["steps"], result["taylor_launches"]
    assert st["eager"] + st["replays"] == mod.NITERS, st
    assert tl["forward"] == tl["backward"] == st["eager"] + st["graphs"], (
        st, tl)
    assert result["world"] == torch.cuda.device_count(), result
    assert result["backend"] == "nccl", result
    n = st["eager"] + st["replays"]
    return dict(numbers=result, seconds=seconds,
                fits=[dict(steps=mod.NITERS, kind="Adam",
                           it_s=result["it_s"], tally=st)],
                launches={"fused_taylor_forward": tl["forward"],
                          "fused_taylor_backward": tl["backward"],
                          "fused_taylor_jvp": 0, "fused_mlp_forward": 0},
                device_launches=[n, n, 0])


def phase_examples():
    """Phase 15: each file of examples_torch/ through its own main() on the
    card, in EXAMPLE_ROUTES' order, held to its own asserts and its route;
    one JSON line an example.  Every kernel's plain version raises (19's
    artifact, which holds the plain forward by design, aside).  Returns
    the path's launches (wrapper counts, summed over the examples) and
    the Taylor kernels' launches on the device."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    t0 = time.perf_counter()
    rows, path, device = {}, {}, [0, 0, 0]
    for name, (route, chain) in EXAMPLE_ROUTES.items():
        for c in _finisher_counters() + (fm.fused_mlp_forward,):
            c.launches = 0
        if name.startswith("18"):
            row = _run_example_18()
        elif name.startswith("19"):
            row = _run_example(name, route, chain)
        elif name.startswith("09"):
            with _plain_refused():
                row = _run_example(name, route, chain, _ex09_claim)
        else:
            with _plain_refused():
                row = _run_example(name, route, chain)
        free_card()
        rows[name] = row
        device = [a + b for a, b in zip(device, row["device_launches"])]
        for k, v in row["launches"].items():
            path[k] = path.get(k, 0) + v
        print(json.dumps({"example": name, **row}, default=_json_default),
              flush=True)
        log(f"example {name}: {row['seconds']:.2f} s, "
            + ", ".join(f"{f['kind']} {f['steps']} steps {f['it_s']:.1f} "
                        "it/s" for f in row["fits"])
            + f"; launches {row['launches']}")
    seconds = time.perf_counter() - t0
    log(f"examples path launches (counted from 0 before each example): "
        f"{path}; Taylor kernels on the device {device}; {seconds:.1f} s")
    assert all(path.values()), path
    return path, dict(zip(("fused_taylor_forward", "fused_taylor_backward",
                           "fused_taylor_jvp"), device)), rows, seconds


# Phase 16: tutorials_torch/'s notebooks, each code cell verbatim on the
# card (DEVICE = None) at the notebooks' own budgets and asserts.
NOTEBOOKS_DIR = "tutorials_torch"
NOTEBOOKS = ("1_solving_pdes.ipynb", "2_torch_examples.ipynb")


def _notebook_code(name):
    """A notebook's code cells, read as JSON (no nbformat needed)."""
    with open(os.path.join(NOTEBOOKS_DIR, name), encoding="utf-8") as f:
        cells = json.load(f)["cells"]
    return ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]


def _fit_route(solver):
    """"kernels" where the solver's plan runs through the Taylor kernels
    (a planned chain in their scope, as the model decided at its first
    step), else "plain"."""
    plans = getattr(solver.model, "_taylor_plans", {})
    return ("kernels" if solver._plan_ok
            and any(p is not None for p in plans.values()) else "plain")


def _run_notebook(name):
    """One notebook's code cells in one namespace, watched
    (``_watched_solvers``) and with their prints captured: every fit held
    to its route (``_example_fit_route``: on the kernels' route each step
    launched the Taylor forward and backward as its kind's design says),
    every model call and ``predict`` one MLP launch where the chain is in
    the kernel's scope, none elsewhere; then the notebook's last
    ``solver.ctx.run(solver.model, xs)`` against ``solver.predict(xs)``
    (1e-6; bitwise equality reported), one MLP launch each in scope.
    Returns the row and the Taylor launches on the device."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    counters = _finisher_counters() + (fm.fused_mlp_forward,)
    fits, predicts, printed, namespace = [], [], [], {}
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    with _watched_solvers(fits, predicts):
        for i, src in enumerate(_notebook_code(name)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                exec(compile(src, f"{name} code cell {i}", "exec"),
                     namespace)
            printed += out.getvalue().splitlines()
    sync()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    assert namespace["DEVICE"] is None and "solver" in namespace
    device, routes = [0, 0, 0], []
    for i, f in enumerate(fits):
        routes.append(_fit_route(f["solver"]))
        dev = _example_fit_route(f, routes[-1], f"{name} fit {i}")
        device = [a + b for a, b in zip(device, dev)]
    assert "kernels" in routes, routes
    assert all(n == int(in_scope) for n, in_scope in predicts), predicts
    solver, xs = namespace["solver"], namespace["xs"]
    mlp0 = fm.fused_mlp_forward.launches
    via_ctx = np.asarray(solver.ctx.run(solver.model, xs))
    pred = solver.predict(xs)
    in_scope = solver.model._mlp_plan is not None
    assert fm.fused_mlp_forward.launches - mlp0 == 2 * int(in_scope)
    np.testing.assert_allclose(via_ctx, pred, rtol=0, atol=1e-6)
    row = dict(seconds=seconds, launches=launches, device_launches=device,
               fits=[dict(r, route=route)
                     for r, route in zip(_fit_rows(fits), routes)],
               predicts=[n for n, _ in predicts], printed=printed,
               ctx_vs_predict=dict(
                   max_abs_diff=float(np.max(np.abs(via_ctx - pred))),
                   bitwise=bool(np.array_equal(via_ctx, pred)),
                   mlp_in_scope=in_scope))
    return row, device


def phase_notebooks():
    """Phase 16: each notebook of tutorials_torch/ verbatim on the card
    (``_run_notebook``), every kernel's plain version refused; one JSON
    line a notebook.  Returns the path's launches (wrapper counts, summed
    over the notebooks, each counted from 0), the Taylor kernels' launches
    on the device, the rows and the phase's seconds."""
    from pydens_tpu_torch.ops import fused_mlp as fm
    t0 = time.perf_counter()
    rows, path, device = {}, {}, [0, 0, 0]
    for name in NOTEBOOKS:
        for c in _finisher_counters() + (fm.fused_mlp_forward,):
            c.launches = 0
        with _plain_refused():
            row, dev = _run_notebook(name)
        free_card()
        rows[name] = row
        device = [a + b for a, b in zip(device, dev)]
        for k, v in row["launches"].items():
            path[k] = path.get(k, 0) + v
        print(json.dumps({"notebook": name, **row}, default=_json_default),
              flush=True)
        log(f"notebook {name}: {row['seconds']:.2f} s, "
            + ", ".join(f"{f['kind']} {f['steps']} steps {f['it_s']:.1f} "
                        f"it/s ({f['route']})" for f in row["fits"])
            + f"; launches {row['launches']}; ctx.run vs predict "
            f"{row['ctx_vs_predict']}")
    seconds = time.perf_counter() - t0
    log(f"notebooks path launches (counted from 0 before each notebook): "
        f"{path}; Taylor kernels on the device {device}; {seconds:.1f} s")
    assert path["fused_taylor_forward"] and path["fused_taylor_backward"]
    assert path["fused_mlp_forward"], path
    return path, dict(zip(("fused_taylor_forward", "fused_taylor_backward",
                           "fused_taylor_jvp"), device)), rows, seconds


def carry_probe(steps, out_dir=os.path.join("build", "carry")):
    """Runs ``steps`` in this one process, in order: earlier phases by name,
    phase 11's arms (``FEATURE_ARMS``), the files of examples_torch/ by
    stem, ``ex26`` (examples/26's separable fit,
    ``D`` on grid leaves, phase 13's budget), ``first_order`` /
    ``second_order`` (5,000 small backward passes), and
    ``deterministic``, which turns
    on ``torch.use_deterministic_algorithms(True, warn_only=True)`` for
    the steps after it and logs the ops that warn (those without a
    deterministic implementation).  Saves the loss history and initial
    parameters of each arm it ran to ``out_dir/<steps>.npz`` (keys
    ``<position>_<arm>``), so that two probes show the first step at
    which earlier work in a process changed an arm's fit; an arm run more
    than once in one probe logs, for each later run, the first step at
    which its history differs from the first run's, and whether all its
    runs agree bit for bit."""
    import warnings
    phases = {"kernels": phase_kernels, "poisson": phase_poisson,
              "wide": phase_wide_fit, "tutorials": phase_tutorials,
              "graph_vs_eager": phase_graph_vs_eager,
              "loop": phase_loop_features, "finishers": phase_finishers,
              "collocation": phase_collocation}
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, "-".join(steps) + ".npz")
    saved = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            _carry(steps, phases, saved)
        finally:
            np.savez(dest, **saved)
            by_arm = {}
            for key in sorted(saved, key=lambda k: int(k.split("_")[0])):
                by_arm.setdefault(key.split("_", 1)[1], []).append(
                    saved[key])
            for arm, runs in by_arm.items():
                if len(runs) < 2:
                    continue
                firsts = []
                for run in runs[1:]:
                    diff = (np.flatnonzero(runs[0] != run)
                            if run.shape == runs[0].shape else [0])
                    firsts.append(int(diff[0]) if len(diff) else None)
                log(f"carry probe {arm}: {len(runs)} runs, first step "
                    f"differing from the first run's {firsts} of "
                    f"{runs[0].size}; bit for bit "
                    f"{all(f is None for f in firsts)}")
            ops = sorted({str(w.message)[:200] for w in caught
                          if "determinis" in str(w.message)})
            torch.use_deterministic_algorithms(False)
            log(f"carry probe {steps}: loss histories {sorted(saved)} in "
                f"{dest}; ops warned under deterministic algorithms: "
                f"{json.dumps(ops)}")


def _OpTrace():
    """A dispatch mode that keeps, for each op run under it, a line: the
    op, its tensor inputs' shapes, strides and addresses modulo 4096, and
    a hash of its tensor outputs' bytes."""
    import hashlib
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class OpTrace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))

            def digest(t):
                try:
                    return hashlib.sha1(t.detach().cpu().contiguous()
                                        .numpy().tobytes()).hexdigest()[:12]
                except (NotImplementedError, RuntimeError):
                    return "no data"   # a meta or wrapped tensor

            def where(t):
                try:
                    return (tuple(t.shape), t.stride(), t.data_ptr() % 4096)
                except (NotImplementedError, RuntimeError):
                    return (tuple(t.shape), "no data")
            ins = [where(t) for t in tree_flatten((args, kwargs))[0]
                   if torch.is_tensor(t)]
            outs = [digest(t) for t in tree_flatten(out)[0]
                    if torch.is_tensor(t)]
            self.rows.append(f"{func} {ins} -> {outs}")
            return out
    return OpTrace()


def backward_work(second, reps=5000):
    """``reps`` small backward passes on the card, first order only or
    each with a second-order pass through the graph the first one made
    (``create_graph=True``: its nodes are made on the autograd engine's
    device thread)."""
    x = torch.linspace(-1, 1, 64, device="cuda", requires_grad=True)
    for _ in range(reps):
        g, = torch.autograd.grad(torch.tanh(x).pow(3).sum(), x,
                                 create_graph=second)
        if second:
            torch.autograd.grad(g.sum(), x)
    sync()
    log(f"backward work: {reps} {'second' if second else 'first'}-order "
        "passes")


def ex16_trace(niters=200, reps=2000):
    """examples/16's first ``niters`` Adam steps with and without its
    adaptive collocation, one step a chunk: the loss and the parameters
    after every step (``loss_*``, ``theta_*``).  Then ``torch.cumsum`` of
    one seeded vector of the adaptive pool's size, ``reps`` times: the
    first result and the count of results unequal to it."""
    from pydens_tpu_torch import solver as sv
    out, pick = {}, sv._adaptive_pick

    def spy(r, u, m_pool):
        """The adaptive pick, its operands and results kept where it runs
        eagerly (the warm-up step)."""
        idx, w = pick(r, u, m_pool)
        if not torch.cuda.is_current_stream_capturing():
            for k, v in dict(r=r, u=u, idx=idx, w=w).items():
                out[f"pick0_{k}"] = v.detach().cpu().numpy()
        return idx, w
    for tag, kw in (("adaptive", dict(adaptive=8)), ("uniform", {})):
        s, sampler = _burgers()
        thetas = []
        warm_up = sv._FitStep._warm_up

        def traced(step, fn, tag=tag):
            """The warm-up step under ``_OpTrace``: each op it runs."""
            with _OpTrace() as ops:
                warm_up(step, fn)
            out[f"ops0_{tag}"] = np.asarray(ops.rows)
        sv._FitStep._warm_up = traced

        def keep(_, __, s=s, thetas=thetas):
            theta = list(s._step_cache.values())[-1].theta
            thetas.append(theta.detach().cpu().numpy())
        sv._adaptive_pick = spy
        try:
            s.fit(niters=niters, batch_size=2048, lr=2e-3, sampler=sampler,
                  chunk_size=1, callback=keep, progress=False, **kw)
        finally:
            sv._adaptive_pick = pick
            sv._FitStep._warm_up = warm_up
        if "pick0_r" in out and "pick0_w_again" not in out:
            # The same pick again, on the default stream, from the kept r.
            again = pick(torch.as_tensor(out["pick0_r"], device="cuda"),
                         torch.as_tensor(out["pick0_u"], device="cuda"),
                         out["pick0_r"].shape[0])
            out["pick0_idx_again"] = again[0].cpu().numpy()
            out["pick0_w_again"] = again[1].cpu().numpy()
        out[f"theta_{tag}"] = np.stack(thetas)
        out[f"loss_{tag}"] = np.asarray(s.losses, np.float64)
        del s
        free_card()
    # The pool's forward pieces at theta_0, eagerly, and products of its
    # shapes, each on seeded inputs.
    s, sampler = _burgers()
    pool = torch.as_tensor(np.asarray(sampler.sample(8 * 2048 - 1024),
                                      np.float32), device="cuda")
    with torch.no_grad():
        out["pool_value"] = s.model.network_apply(
            s.model.params["net"], pool).cpu().numpy()
    spec = sv._FlatSpec(s.model.params)
    theta = spec.flatten(s.model.params).detach().clone()
    # The pool's taps four ways: the model's own tensors or views into a
    # flat theta (as a fit step holds them), on the default stream or on
    # a new one (as a fit step's warm-up runs).
    for how, params in (("own", s.model.params),
                        ("views", spec.unflatten(theta))):
        for where in ("default", "side"):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side) if where == "side" else (
                    contextlib.nullcontext()):
                taps = s.model.full_taps(params, pool, s._plan_derivs)
            torch.cuda.current_stream().wait_stream(side)
            for mi, tap in taps.items():
                out[f"pool_tap_{how}_{where}_{mi}"] = (
                    tap.detach().cpu().numpy())
    del s, taps
    free_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for m in (2048, 15360):
        for k, n in ((2, 20), (20, 20), (20, 1)):
            a = torch.randn((m, k), generator=g, device="cuda")
            b = torch.randn((k, n), generator=g, device="cuda")
            out[f"mm_{m}_{k}_{n}"] = (a @ b).cpu().numpy()
    x = torch.rand(8 * 2048 - 1024, generator=g, device="cuda")
    x = x / x.sum()
    first = torch.cumsum(x, 0)
    unequal = sum(int(not torch.equal(torch.cumsum(x, 0), first))
                  for _ in range(reps))
    out["cumsum"] = first.cpu().numpy()
    log(f"ex16 trace: {niters} steps a chunk each; cumsum of "
        f"{x.numel()} floats unequal to its first result {unequal} times "
        f"of {reps}")
    return out


def order_fit(nested):
    """A short fit through one of the other nested-gradient paths, for the
    carry probe: examples/16's adaptive fit with ``fast_taps=False`` (``D``
    by ``create_graph`` gradients; ``nested``), or the README Poisson
    problem with a Neumann constraint through ``f.grad`` (the
    constraints' nested gradients on the plan).  Its loss history and
    final theta."""
    from pydens_tpu_torch import Solver
    if nested:
        s, sampler = _burgers()
        s.fit(niters=60, batch_size=2048, lr=2e-3, sampler=sampler,
              adaptive=8, chunk_size=20, fast_taps=False, progress=False)
    else:
        s = Solver(_pde(), seed=0, constraints=lambda f, x, y: f.grad(
            np.array([0.0]), np.array([0.5]), wrt=0) - 1.0, **README)
        s.fit(niters=100, batch_size=100, progress=False,
              loss_terms={"equation": 1.0, "constraint_0": 1.0})
    out = dict(loss=np.asarray(s.losses, np.float64),
               theta=s._spec().flatten(s.model.params).detach().cpu().numpy())
    log(f"order fit ({'nested D' if nested else 'f.grad constraint'}): "
        f"loss {out['loss'][0]:.6e} -> {out['loss'][-1]:.6e}")
    del s
    free_card()
    return out


def _carry(steps, phases, saved):
    for i, step in enumerate(steps):
        if step in ("order_nested", "order_grad"):
            saved.update({f"{i}_{k}": v for k, v in order_fit(
                step == "order_nested").items()})
            continue
        if step == "deterministic":
            torch.use_deterministic_algorithms(True, warn_only=True)
            continue
        if step == "ex16_trace":
            saved.update({f"{i}_{k}": v for k, v in ex16_trace().items()})
            continue
        if step in ("first_order", "second_order"):
            backward_work(second=step == "second_order")
            continue
        if step == "ex26":
            s = _ex26_solver()
            with _plain_refused():
                collocation_fit(s, "ex26", False, **EX26_FIT)
            saved[f"{i}_{step}"] = np.asarray(s.losses, np.float64)
            log(f"carry ex26: loss {s.losses[0]:.6e} -> "
                f"{s.losses[-1]:.6e}")
            del s
            free_card()
            continue
        if os.path.exists(os.path.join(EXAMPLES_DIR, f"{step}.py")):
            with _plain_refused():
                solver, numbers = _example_module(step).main()
            saved[f"{i}_{step}"] = np.asarray(solver.losses, np.float64)
            log(f"carry {step}: {json.dumps(numbers)}")
            del solver
            free_card()
            continue
        if step in phases:
            if step == "collocation":   # as main() runs it
                with _plain_refused():
                    phases[step]()
            else:
                phases[step]()
            continue
        hist = {}
        try:
            with _plain_refused():
                phase_model_features([step], hist)
        finally:
            saved.update({f"{i}_{k}": v for k, v in hist.items()})


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
            *plan.kernel_args(), plan.out_dim, plan.n_params, grid, 1,
            stream) == 0
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
                x.data_ptr(), None, packed.data_ptr(), v.data_ptr(),
                tab.data_ptr(),
                outs[2].data_ptr(), outs[3].data_ptr(), n, plan.n_params,
                plan.n_streams, plan.wmax, plan.out_dim, plan.jvp_tile,
                int(plan.jvp_resident), grid, 1, stream) == 0
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


STATES_SHAPES = {
    "wide": (65537, POISSON_CLOSURE, 2),
    "wide_n262144": (262144, POISSON_CLOSURE, 2),
    "wide_heat": (65537, HEAT_CLOSURE, 3),
}


def states_turns(reps=20):
    """The 64-wide chain's Taylor forward keeping its states (``keep``)
    against keeping none (``none``), and the backward from those states
    (``states``) against the backward that recomputes them
    (``recompute``), in turns (A, B, B, A; CUDA events, ``reps`` wrapper
    calls each) at ``STATES_SHAPES``: the two backwards bitwise equal and
    held to the plain twin; blocks an SM of the forward and both backwards
    from the occupancy calculator; a Levenberg-Marquardt step's 51
    backwards of one forward, as the two paths' sums; then
    ``states_memory``."""
    from pydens_tpu_torch.ops import fused_taylor as ft
    from pydens_tpu_torch.ops._build import load_library
    lib = load_library()
    rows = {}
    for tag, (n, closure, in_dim) in STATES_SHAPES.items():
        plan, packed, x = _taylor_case("fa fa fa f", [64, 64, 64, 1], "Tanh",
                                       n, 0, closure, in_dim)
        per_sm = [lib.pdt_taylor_blocks_per_sm(k, plan.n_params,
                                               plan.n_streams, plan.wmax)
                  for k in range(3)]
        out, states = ft.fused_taylor_forward(packed, x, plan,
                                              keep_states=True)
        ref = ft.fused_taylor_forward_plain(packed, x, plan)
        g = 2.0 * ref / ref.numel()   # cotangent of mean(out ** 2)
        dp, dx = ft.fused_taylor_backward(packed, x, g, plan)
        sp, sx = ft.fused_taylor_backward(packed, x, g, plan, states)
        rdp, rdx = ft.fused_taylor_backward_plain(packed, x, g, plan)
        sync()
        torch.testing.assert_close(out, ref, **VALUE_TOL)
        assert torch.equal(out, ft.fused_taylor_forward(packed, x, plan))
        for a, b in ((dp, rdp), (dx, rdx), (sp, rdp), (sx, rdx)):
            torch.testing.assert_close(a, b, **GRAD_TOL)
        bitwise = bool(torch.equal(dp, sp) and torch.equal(dx, sx))
        diff = max(max_err(dp, sp), max_err(dx, sx))
        del ref, rdp, rdx
        free_card()
        fwd = {"none": lambda: ft.fused_taylor_forward(packed, x, plan),
               "keep": lambda: ft.fused_taylor_forward(packed, x, plan,
                                                       keep_states=True)}
        bwd = {"recompute": lambda: ft.fused_taylor_backward(packed, x, g,
                                                             plan),
               "states": lambda: ft.fused_taylor_backward(packed, x, g, plan,
                                                          states)}
        times = {}
        for pair in (fwd, bwd):
            (a, fa), (b, fb) = pair.items()
            a1, b1, b2, a2 = (time_ms(f, reps) for f in (fa, fb, fb, fa))
            times[a], times[b] = [a1, a2], [b1, b2]
        mean = {k: sum(v) / 2 for k, v in times.items()}
        bounds = taylor_bounds(plan, n)
        row = dict(n=n, n_streams=plan.n_streams, ms=times,
                   blocks_per_sm=dict(zip(("fwd", "bwd_recompute",
                                           "bwd_states"), per_sm)),
                   states_bytes=4 * states.numel(), bitwise_equal=bitwise,
                   max_abs_diff=diff,
                   fwd_share={k: 100 * bounds["fwd"][0] / mean[k]
                              for k in fwd},
                   bwd_share={k: 100 * bounds["bwd"][0] / mean[k]
                              for k in bwd},
                   lm_step_ms={"recompute": 51 * mean["recompute"]
                               + mean["none"],
                               "states": 51 * mean["states"] + mean["keep"]})
        rows[tag] = row
        log(f"states turns {tag} n={n} streams {plan.n_streams}: forward "
            f"none {times['none'][0]:.4f} / {times['none'][1]:.4f} ms, keep "
            f"{times['keep'][0]:.4f} / {times['keep'][1]:.4f} ms "
            f"({4 * states.numel() / 1e6:.1f} MB of states); backward "
            f"recompute {times['recompute'][0]:.4f} / "
            f"{times['recompute'][1]:.4f} ms, states "
            f"{times['states'][0]:.4f} / {times['states'][1]:.4f} ms "
            f"({mean['recompute'] / mean['states']:.3f}x); "
            f"{_share(mean['states'], bounds['bwd'][0])} from states, "
            f"{100 * bounds['bwd'][0] / mean['recompute']:.1f}% recomputing; "
            f"blocks/SM fwd {per_sm[0]}, bwd {per_sm[1]} / {per_sm[2]}; "
            f"gradients bitwise equal: {bitwise} (max |diff| {diff:.3e})")
        del out, states, dp, dx, sp, sx, g
        free_card()
    rows["fit_memory"] = states_memory()
    print(json.dumps({"states_turns": rows}), flush=True)


# The 64-wide Poisson fits whose memory states_memory reads:
# (optimizer, batch, members, steps).
STATES_FITS = (("Adam", 65536, 1, 5), ("Adam", 262144, 1, 5),
               ("Adam", 1048576, 1, 5), ("Adam", 65536, 4, 5),
               ("LM", 65536, 1, 2))


def states_memory():
    """Peak device memory of 64-wide Poisson fits through ``Solver`` (the
    eager step, the capture and replays) beyond what the solver held
    before the fit, with the forward keeping its states and, for the
    same fit on a fresh solver, recomputing them (``_device_bytes`` read
    as 0, so ``TaylorPlan.keeps_states`` says no); the two fits' losses
    bitwise equal."""
    from pydens_tpu_torch import Solver
    from pydens_tpu_torch.ops import fused_taylor as ft
    bwd = ft.fused_taylor_backward
    card = ft._device_bytes
    plan = _taylor_case(WIDE["layout"], WIDE["units"], WIDE["activation"],
                        16, 0, POISSON_CLOSURE, 2)[0]
    rows = []
    for opt, batch, k, steps in STATES_FITS:
        row = dict(optimizer=opt, batch=batch, members=k, steps=steps)
        losses = {}
        for path in ("states", "recompute"):
            ft._device_bytes = card if path == "states" else lambda d: 0
            try:
                solver = Solver(_pde(), seed=0, n_models=k, **WIDE)
                sync()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                calls, reads = bwd.launches, bwd.from_states
                solver.fit(niters=steps, batch_size=batch, optimizer=opt,
                           progress=False)
                sync()
            finally:
                ft._device_bytes = card
            row[path] = dict(
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                held_bytes=torch.cuda.memory_allocated() - base,
                backward_calls=bwd.launches - calls,
                from_states=bwd.from_states - reads)
            losses[path] = np.asarray(solver.losses)
            del solver
            free_card()
        row["states_bytes"] = 4 * plan.state_floats(batch, k)
        row["losses_bitwise_equal"] = bool(
            np.array_equal(losses["states"], losses["recompute"]))
        assert row["states"]["from_states"] == row["states"]["backward_calls"]
        assert row["recompute"]["from_states"] == 0
        rows.append(row)
        log(f"states memory {opt} batch {batch} K={k}: peak "
            f"{row['states']['peak_bytes'] / 2**20:.1f} MiB keeping the "
            f"states ({row['states_bytes'] / 2**20:.1f} MiB of them), "
            f"{row['recompute']['peak_bytes'] / 2**20:.1f} MiB recomputing; "
            f"held after the fit {row['states']['held_bytes'] / 2**20:.1f} / "
            f"{row['recompute']['held_bytes'] / 2**20:.1f} MiB; losses "
            f"bitwise equal: {row['losses_bitwise_equal']}")
    return rows


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
    if sys.argv[1:] == ["--model-features"]:
        with _plain_refused():
            print(json.dumps({"model_features": phase_model_features()[1]}),
                  flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--ensembles"]:
        with _plain_refused():
            print(json.dumps({"ensembles": phase_ensembles()[1]}),
                  flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--symbolic"]:
        with _plain_refused():
            print(json.dumps({"symbolic": phase_symbolic()[1]}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--scale-out"]:
        print(json.dumps({"scale_out": phase_scale_out()[1]},
                         default=_json_default), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--examples"]:
        phase_examples()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--notebooks"]:
        phase_notebooks()
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--carry"]:
        carry_probe(sys.argv[2].split(","), *sys.argv[3:4])
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
    if sys.argv[1:] == ["--states-turns"]:
        states_turns()
        print(smi, flush=True)
        return 0
    taylor, tut_taylor, mlp, tut_mlp, jvp, members = phase_kernels()
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
    with _plain_refused():
        feature_launches, features = phase_model_features()
    print(json.dumps({"model_features": features}), flush=True)
    with _plain_refused():
        ensemble_launches, ensembles = phase_ensembles()
    print(json.dumps({"ensembles": ensembles}), flush=True)
    with _plain_refused():
        symbolic_launches, symbolic = phase_symbolic()
    print(json.dumps({"symbolic": symbolic}), flush=True)
    scale_launches, scale_out = phase_scale_out()
    print(json.dumps({"scale_out": scale_out}, default=_json_default),
          flush=True)
    example_launches, example_device, _, example_s = phase_examples()
    notebook_launches, notebook_device, _, notebook_s = phase_notebooks()
    path_launches = {k: {"w1": launches[k],
                         **{w: t[0][k] for w, t in tutorials.items()},
                         **{f"p10_{arm}": n[k] for arm, n
                            in collocation_launches.items()},
                         **{f"p11_{arm}": n[k] for arm, n
                            in feature_launches.items()},
                         "p12_ensembles": ensemble_launches[k],
                         "p13_symbolic": symbolic_launches.get(k, 0),
                         "p14_scale_out": scale_launches[k],
                         "p15_examples": example_launches[k],
                         "p16_notebooks": notebook_launches[k]}
                     for k in launches}
    # Launches on the card: the Taylor kernels once per fit step (eager or
    # replayed), the MLP kernel once per predict (never captured).
    device_launches = {"w1": w1_device,
                       **{w: t[1] for w, t in tutorials.items()}}
    all_taylor = taylor + list(tut_taylor.values())
    fwd_err = max(e["fwd"] for e, _ in all_taylor)
    bwd_err = max(e["bwd"] for e, _ in all_taylor)
    # The shapes whose chain starts from an embedding's Taylor state.
    state_taylor = {k: e for k, (e, t) in tut_taylor.items()
                    if t["input_state"]}
    state_jvp = {k: e for k, (e, t) in jvp.items() if t["input_state"]}
    main_taylor = taylor[0][1]          # README shapes: n = 100
    main_mlp = mlp["readme_n10000"][1]  # README predict: 10,000 points
    shapes = {"readme_n1000": taylor[1][1],
              "wide": taylor[2][1],     # 64-wide chain, n = 65,537
              "wide_n262144": taylor[3][1],
              "wide_heat": taylor[4][1],
              **{key: times for key, (_, times) in tut_taylor.items()}}
    mlp_shapes = {key: times for key, (_, times)
                  in list(mlp.items())[1:] + list(tut_mlp.items())}

    # The Taylor kernels' direct-call paths beside the fit's: the forward
    # keeping no states, the backward recomputing them.
    secondary = (("no_states_", "_no_states"), ("recompute_", "_recompute"))

    def shape_times(key, table):
        return {f"{tag}_{kind}ms": times[key + suffix]
                for tag, times in table.items()
                for kind, suffix in (("", ""), ("plain_", "_plain"),
                                     ("bound_", "_bound")) + secondary
                if key + suffix in times}

    def entry(name, src, replaces, times, key, err, table, kernel=None):
        # No single PyTorch call computes a Taylor traversal or a layout
        # chain with its skip stack: library_ms is null.  ``launches`` is
        # the wrapper's count on the main path (eager steps and captures);
        # a captured kernel's launches on the card, and per replayed step,
        # follow.
        graph = ({"path_device_launches": {
                      **device_launches,
                      "p15_examples": example_device[name],
                      "p16_notebooks": notebook_device[name]},
                  "graph_launches_per_step": w1_prof[f"{kernel}_per_step"]}
                 if kernel else {"path_device_launches": path_launches[name]})
        return {"name": name, "route": "cuda",
                "source": f"pydens_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": times[key],
                "plain_ms": times[f"{key}_plain"],
                "bound_ms": times[f"{key}_bound"],
                "bound_by": times[f"{key}_bound_by"], "library_ms": None,
                **{f"{kind}ms": times[key + suffix]
                   for kind, suffix in secondary if key + suffix in times},
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
        "p14_scale_out_launches": scale_launches["fused_taylor_jvp"],
        "p15_examples_launches": example_launches["fused_taylor_jvp"],
        "p15_examples_device_launches": example_device["fused_taylor_jvp"],
        "p16_notebooks_launches": notebook_launches["fused_taylor_jvp"],
        "p16_notebooks_device_launches": notebook_device["fused_taylor_jvp"],
        "lm_launches_per_step":
            finishers["ode_lm"]["taylor_jvp_kernel_per_step"],
        "input_state_shapes": sorted(state_jvp),
        "input_state_max_abs_err": max(state_jvp.values())}
    # The member axis (the grid's second axis, K ensemble members in one
    # launch): one more entry a kernel, its launches phase 12's path, its
    # times examples/08's at K = 8 (Taylor kernels at 400 points, the MLP
    # at 10,000), every MEMBER_ROWS row beside them.
    def member_entry(name, src, replaces, kind, headline):
        errs, times = members[headline]
        return {"name": f"{name} (member axis)", "route": "cuda",
                "source": f"pydens_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": ensemble_launches[name],
                "max_abs_err": max(e[kind] for e, _ in members.values()
                                   if kind in e),
                "ms": times[kind], "plain_ms": times[f"{kind}_plain"],
                "bound_ms": times[f"{kind}_bound"],
                "bound_by": times[f"{kind}_bound_by"], "library_ms": None,
                **{f"{tag}_{k}ms": t[kind + suffix]
                   for tag, (_, t) in members.items() if kind in t
                   for k, suffix in (("", ""), ("plain_", "_plain"),
                                     ("bound_", "_bound"))},
                "grid_per_member": {tag: t["grid_per_member"]
                                    for tag, (_, t) in members.items()}}
    member_kernels = [
        member_entry("fused_taylor_forward", "fused_taylor.cu",
                     "pydens_tpu/ops/pallas_taylor.py:386", "fwd",
                     "ex08_k8"),
        member_entry("fused_taylor_backward", "fused_taylor.cu",
                     "pydens_tpu/ops/pallas_taylor.py:428", "bwd",
                     "ex08_k8"),
        member_entry("fused_mlp_forward", "fused_mlp.cu",
                     "pydens_tpu/ops/pallas_mlp.py:92", "mlp", "ex08_k8"),
        member_entry("fused_taylor_jvp", "fused_taylor.cu",
                     "pydens_tpu/solver.py:1349 (jax.linearize of the plan; "
                     "no Pallas kernel)", "jvp", "ex08_k8"),
    ]
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
    ] + member_kernels
    for item, kind in zip(kernels[:2], ("fwd", "bwd")):
        item.update(input_state_shapes=sorted(state_taylor),
                    input_state_max_abs_err=max(
                        e[kind] for e in state_taylor.values()))
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"phase 15 (examples): {example_s:.1f} s; phase 16 (notebooks): "
        f"{notebook_s:.1f} s; the whole run {time.perf_counter() - _T0:.1f} "
        "s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
