"""The benchmark's driver: finds a cell's files by name, runs its set-up,
its window (timed, or traced) and its check, and assembles the result.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``portbench/workloads/<cell>.json``: the configuration's name, the
  traffic kind, its parameters, and the limit of each number compared;
* ``portbench/configs/<config>.json``: the model and the problem;
* ``portbench/traffic/<kind>.py``: the traffic kind (``portbench/cell.py``
  says what it gives);
* ``portbench/layer_metrics/<metric>.py``: a reader ``read(reading)`` of a
  per-layer metric from the traced window (``portbench/trace.py``); it
  returns None where it finds nothing to read.  A metric split by the kind
  of cell, ``<name>.<kind>``, without a file of its own is read by the
  reader of ``<name>`` (the longest such prefix that has a file).

A per-layer metric lists the cells that report it under ``workloads``; an
end-to-end metric does so unless every cell reports it (``setup_s``).
"""

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import trace
from portbench.cell import Context

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name):
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def workload_names():
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(kind):
    return _module(HERE / "traffic" / f"{kind}.py",
                   f"portbench.traffic.{kind}")


def reader(metric):
    name = metric
    while "." in name and not (HERE / "layer_metrics" / f"{name}.py").exists():
        name = name.rsplit(".", 1)[0]
    return _module(HERE / "layer_metrics" / f"{name}.py",
                   f"portbench.layer_metrics.{name}")


def metrics_of(bench, cell, section):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) whose
    ``workloads`` list ``cell``, and the end-to-end ones without a list."""
    return [m for m in bench[section]
            if cell in m.get("workloads", ())
            or (section == "end_to_end" and "workloads" not in m)]


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(name, seed, seconds, traced, device, t_start, overrides=None,
             bench=None):
    """Run cell ``name`` and return its result object (the dict printed as
    the last line).  ``overrides`` replace traffic parameters (the CPU
    tests run a cell at a small size)."""
    bench = manifest() if bench is None else bench
    listed = {w["name"]: w for w in bench["workloads"]}
    if name not in listed:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    wl = workload(name)
    if (wl["config"], wl["traffic"]) != (listed[name]["config"],
                                         listed[name]["traffic"]):
        raise SystemExit(f"{name}: workload file and BENCHMARK.json differ")
    params = dict(wl["params"], **(overrides or {}))
    ctx = Context(config(wl["config"]), params, int(seed), device)
    cuda = device.type == "cuda"
    cell = traffic(wl["traffic"]).Traffic(ctx)

    cell.prepare()
    cell.warm()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {setup_s:.3f} s")

    attempted = failed = 0
    metrics, extra, busy = {}, {}, {}
    if traced:
        units = params["trace_units"]
        reading, extra["breakdown"] = trace.reading(cell, units)
        attempted = units
        busy = {"busy_s": reading.busy_s, "window_s": reading.window_s}
    else:
        cell.window_begin()
        t0 = time.perf_counter()
        while True:
            failed += int(cell.unit()["failed"])
            attempted += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        values = dict(cell.end_to_end(window_s), setup_s=setup_s)
        for m in metrics_of(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        log(f"{name}: window {window_s:.3f} s, {attempted} units")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    cell.release()
    numbers = cell.judge()
    limits = wl["limits"]
    correct = (set(numbers) == set(limits)
               and all(math.isfinite(v) and v <= limits[k]
                       for k, v in numbers.items()))
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    if traced:
        reading.facts.update(cell.reference_facts())
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"]).read(reading)
            if value is None:
                log(f"{name}: per-layer metric {m['name']} found nothing "
                    "to read; it is left out of the result")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = power_limit() if cuda else None
    result = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": dict(
            platform="gpu" if cuda else "cpu",
            kind=torch.cuda.get_device_name(device) if cuda else "cpu",
            count=1, memory_peak_bytes=int(peak), **busy),
        **extra,
        "card": card,
        "checks": checks,
    }
    log(f"{name}: card {card}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
