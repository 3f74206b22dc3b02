"""Where the early-stopped CG loop of one LM step ends, in pydens_tpu and
in pydens_tpu_torch on the CPU, at the theta of
tests/test_torch_lm.py::test_one_lm_step_matches_jax and at that theta
with every float32 entry moved by one ulp (``chip_smoke.one_ulp``,
patterns 1..k): the spread of the stop under f32 rounding alone.

    python tests/lm_cg_stop_study.py            # cg_tol 1e-3, patterns 1-40
    python tests/lm_cg_stop_study.py 0.07 8     # another tolerance, 1-8

Each loop is JAX's stopping rule (``_jax_cg_iterations``: stop once
r . r <= cg_tol^2 b . b) on its own package's normal-equation matvec.
Prints one JSON line per pattern (0 is the test's theta), then one with
the counts of each stop.
"""

import collections
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import conftest  # noqa: E402,F401  (the CPU backend, as the tests run)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_lm as lm  # noqa: E402
from chip_smoke import one_ulp  # noqa: E402
from pydens_tpu_torch import params_from_jax  # noqa: E402
from pydens_tpu_torch.utils.optimizers import LMConfig  # noqa: E402


def main(cg_tol=1e-3, patterns=40):
    js, ts, terms = lm._pair("ode")
    pts = lm._points(128, seed=5)
    js.fit(niters=100, batch_size=128, lr=0.02, progress=False)
    theta = jax.tree.map(np.asarray, js.model.params)
    cfg = LMConfig(cg_tol=cg_tol)
    stops = collections.Counter()
    for k in range(patterns + 1):
        tree = theta if k == 0 else one_ulp(theta, k)
        js.model.params = jax.tree.map(jnp.asarray, tree)
        ts.model.load_params(params_from_jax(tree))
        row = dict(pattern=k,
                   jax=lm._jax_cg_iterations(js, terms, pts, cfg,
                                             cfg.init_damping),
                   torch=lm._port_cg_iterations(ts, terms, pts, cfg,
                                                cfg.init_damping))
        stops[("jax", row["jax"])] += 1
        stops[("torch", row["torch"])] += 1
        print(json.dumps(row), flush=True)
    print(json.dumps({"cg_tol": cg_tol, "patterns": patterns, "stops": {
        pkg: {str(n): c for (p, n), c in sorted(stops.items()) if p == pkg}
        for pkg in ("jax", "torch")}}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(float(args[0]) if args else 1e-3,
         int(args[1]) if len(args) > 1 else 40)
