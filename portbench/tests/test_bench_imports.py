"""What a run loads: never JAX nor ``pydens_tpu`` (compared by whole
top-level names); the reference loads nothing of the program."""

import json
import subprocess
import sys

from portbench import harness

RUN = harness.HERE / "run.py"


def _python(script):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _python(f"""
import sys, json, time, torch
sys.path.insert(0, {str(harness.ROOT)!r})
torch.set_num_threads(1)
from portbench import harness
sys.argv = ['run.py']
import importlib.util
spec = importlib.util.spec_from_file_location('run', {str(RUN)!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
harness.run_cell('poisson2d-wide64.predict-1m', 1, 0.2, False,
                 torch.device('cpu'), time.perf_counter(),
                 overrides=dict(grid_side=16))
print(json.dumps([run.forbidden_modules(),
                  'pydens_tpu_torch' in sys.modules]))
""")
    assert loaded == [[], True]


def test_the_reference_loads_nothing_of_the_program():
    loaded = _python(f"""
import sys, json, torch
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import harness, inputs
from portbench.reference import pinn
cfg = harness.config('poisson2d-readme')
theta = inputs.weights(cfg, 1, inputs.WEIGHTS, 1, torch.device('cpu'))[0]
pts = torch.rand(32, 2)
pinn.adam_steps(cfg, theta, [pts], 0.005)
pinn.lm_step(cfg, theta, pts, (1e-3, 2.0), 2)
pinn.predict(cfg, theta, pts)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}}
                        & {{'jax', 'jaxlib', 'flax', 'pydens_tpu',
                           'pydens_tpu_torch'}})))
""")
    assert loaded == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location("portbench_run", RUN)
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "pydens_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "pydens_tpu.solver", object())
    assert run.forbidden_modules() == ["jax.numpy", "pydens_tpu.solver"]


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(RUN), "--workload",
         "poisson2d-wide64.adam-b65536", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=harness.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr
