"""BENCHMARK.json and the files it names: the contract's shapes, and every
cell resolving to its configuration, traffic kind and readers by name."""

import json
import re
import shutil
import subprocess
import sys

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_names_and_units_use_the_allowed_characters():
    bench = harness.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["workloads"], m["name"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_resolves_to_its_files():
    bench = harness.manifest()
    for w in bench["workloads"]:
        wl = harness.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        cfg = harness.config(wl["config"])
        assert cfg["name"] == wl["config"] and cfg["reduced"] == []
        module = harness.traffic(wl["traffic"])
        assert hasattr(module, "Traffic") and module.FAULTS
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
        per_layer = harness.metrics_of(bench, w["name"], "per_layer")
        e2e = harness.metrics_of(bench, w["name"], "end_to_end")
        assert per_layer and len(e2e) >= 2
        for m in per_layer:
            assert callable(harness.reader(m["name"]).read)
    listed = {c["file"] for c in bench["configs"]}
    assert listed == {f"portbench/configs/{c['name']}.json"
                      for c in bench["configs"]}
    assert sorted(w["name"] for w in bench["workloads"]) == \
        harness.workload_names()


def test_a_workload_file_added_in_a_copy_is_picked_up(tmp_path):
    """A new cell of an existing traffic kind needs its workload file and
    its BENCHMARK.json entry, and no edit of any file already there."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.manifest()
    new = "poisson2d-wide64.adam-b512"
    bench["workloads"].append(dict(bench["workloads"][0], name=new))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and bench["workloads"][0]["name"] in \
                m["workloads"]:
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((harness.HERE / "workloads" /
                     f"{bench['workloads'][0]['name']}.json").read_text())
    wl["params"]["batch_size"] = 512
    (tmp_path / "portbench" / "workloads" / f"{new}.json").write_text(
        json.dumps(wl))
    script = f"""
import sys, json, time, torch
sys.path[:0] = [{str(tmp_path)!r}, {str(harness.ROOT)!r}]
torch.set_num_threads(1)
from portbench import harness
assert harness.ROOT == __import__('pathlib').Path({str(tmp_path)!r})
print(json.dumps(harness.workload_names()))
r = harness.run_cell({new!r}, 5, 0.2, False, torch.device('cpu'),
                     time.perf_counter(), overrides=dict(chunk_size=2))
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    names, result = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert new in names
    assert result["correct"] and "fit_points_per_s" in result["metrics"]
