"""Readings that a cell's limits are set from (run on the card, never by the
benchmark's own runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 100-111 \
        --control 200-202 --faults 300-302 --seconds 4

For each seed it builds the cell, drives the program through what the
check compares (and, where the cell judges answers of its window, a short
window of ``--seconds`` at the cell's own load), and prints one JSON line
of the numbers compared: ``program`` lines from sound runs,
``control`` lines with the reference computed in TF32 standing in the
program's place, and one line a fault of the traffic kind's ``FAULTS``
(``portbench/faults.py``) planted in the program.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def seeds(spec):
    lo, _, hi = spec.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def reading(module, ctx, seconds, control=False):
    cell = module.Traffic(ctx)
    cell.prepare()
    if seconds > 0:
        cell.warm()
        cell.window_begin()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            cell.unit()
    cell.release()
    return cell.judge(control=control)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args()

    import torch
    from portbench import faults, harness
    from portbench.cell import Context
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    wl = harness.workload(args.workload)
    module = harness.traffic(wl["traffic"])
    config = harness.config(wl["config"])

    def ctx(seed):
        return Context(config, dict(wl["params"]), seed, device)

    runs = ([("program", s, None) for s in seeds(args.seeds)]
            if args.seeds else [])
    runs += ([("control", s, None) for s in seeds(args.control)]
             if args.control else [])
    runs += ([("fault", s, f) for f in module.FAULTS
              for s in seeds(args.faults)] if args.faults else [])
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        if fault is None:
            numbers = reading(module, ctx(seed), args.seconds,
                              control=kind == "control")
        else:
            with faults.planted(fault):
                numbers = reading(module, ctx(seed), args.seconds)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "fault": fault, "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
