"""Benchmark of ``pydens_tpu_torch`` on NVIDIA GPUs: one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cells, their metrics and their
bounds are in ``BENCHMARK.json``; ``portbench/harness.py`` says where each
cell's files are.  ``--trace 0`` measures the cell's end-to-end metrics
over a closed-loop window of ``--seconds``; ``--trace 1`` runs the cell's
traced window under ``torch.profiler`` and reports its per-layer metrics,
the device's busy time and a breakdown.  Either run checks what the timed
path produced against the plain reference (``portbench/reference``) and
prints each number compared beside its limit, as the last lines of
standard error and under ``checks`` in the result.  The last line of
standard output is the result, one JSON object.

Without a CUDA card, or with fewer than the cell asks for, it exits with 2
and prints no result; with a module of JAX or of ``pydens_tpu`` loaded
once the window has closed, with 3.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# Top-level module names no run may load (compared whole: the port's
# ``pydens_tpu_torch`` is not ``pydens_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "pydens_tpu")


def process_age():
    """Seconds since this process started, from ``/proc`` (0 where it cannot
    be read)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    t_start = time.perf_counter() - process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from portbench import harness
    bench = harness.manifest()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # One client process with one compute thread on the host.
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, t_start, bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
