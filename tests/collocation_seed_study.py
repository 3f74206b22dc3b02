"""The collocation options' accuracy over seeds on the CPU, for pydens_tpu
(the reference) or pydens_tpu_torch: the figures that phase 10 of
chip_smoke.py holds the port to.  The solvers and fits are phase 10's,
read from chip_smoke.py.

    python tests/collocation_seed_study.py jax      # pydens_tpu
    python tests/collocation_seed_study.py torch    # pydens_tpu_torch
    python tests/collocation_seed_study.py jax 6 18 uniform   # seeds 6-17

Three studies, seeds 0-5 each unless given:

* adaptive (examples/09_adaptive_collocation.py): ``u' = 100 exp(-2000
  (x - 0.8)^2)``, ``fafaf`` [32, 32, 1] Tanh, IC 0, 1500 Adam steps at lr
  0.01 and batch 128, uniform and ``adaptive=8``; the mean |residual| on
  2000 points (``Solver.residual``);
* RBA (BENCHMARKS.md:722-745): the same ODE and solver on a fixed batch of
  256 (``resample=False``), 2000 Adam steps at lr 0.01, with and without
  ``rba=(0.01, 0.99)``; the max error on 2000 points against the exact
  solution;
* causal: ``w3`` of ``benchmarks/bench_loss_parity.py`` (heat 2D+t with a
  diffusivity parameter, 1000 Adam steps at batch 1500, lr 0.001), plain
  and with ``causal=5.0``; the plain MSE of the trained solver over 50
  batches of 1500 fresh points (the sampler's host draws, the same in both
  packages).

Prints one JSON line per fit, then one with the medians and maxima.
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

XS = np.linspace(0, 1, 2000, dtype=np.float32)
ARMS = {
    "uniform": dict(cs.ADAPTIVE_FIT),
    "adaptive": dict(cs.ADAPTIVE_FIT, adaptive=cs.ADAPTIVE_POOL),
    "fixed": dict(cs.RBA_FIT),
    "rba": dict(cs.RBA_FIT, rba=cs.RBA_ETA_GAMMA),
    "w3_plain": dict(cs.W3_FIT),
    "w3_causal5": dict(cs.W3_FIT, causal=cs.CAUSAL_EPS),
}


def study(pkg_name, arm, seeds):
    """``arm``'s metric for each seed of ``seeds`` (a list), printing one
    JSON line per fit."""
    if pkg_name == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import pydens_tpu as pkg
        extra = {}
    else:
        import pydens_tpu_torch as pkg
        extra = dict(device="cpu")

    def ode(f, x):
        return pkg.D(f, x) - 100 * pkg.exp(-2000 * (x - 0.8) ** 2)

    def heat(f, x, y, t, a):
        return (pkg.D(pkg.D(f, x), x) + pkg.D(pkg.D(f, y), y)
                - a * pkg.D(f, t))

    def solver(seed):
        if arm.startswith("w3"):
            chain = cs.TUTORIAL_CHAINS["w3"][0]
            return pkg.Solver(heat, ndims=3, nparams=1, seed=seed,
                              initial_condition=lambda x, y: 10 * x * y
                              * (1 - x) * (1 - y), boundary_condition=0,
                              layout=chain["layout"],
                              features=chain["features"],
                              activation=chain["act"], **extra)
        return pkg.Solver(ode, seed=seed, **cs.STIFF, **extra)

    def w3_sampler(first=0):
        return (pkg.NS("u", dim=2, seed=first)
                & pkg.NS("u", low=0, high=.5, seed=first + 1)
                & pkg.NS("u", low=.1, high=4, seed=first + 2))

    def plain_mse(s):
        """The plain MSE over fresh batches of w3's batch size."""
        if pkg_name == "jax":
            import jax.numpy as jnp
            loss_fn, *_ = s._build_loss_fn(
                (("equation", 1.0),), lambda a, b: jnp.mean((a - b) ** 2),
                use_plan=True)
            params = s.model.params

            def value(pts):
                return float(loss_fn(params, [jnp.asarray(pts[:, i:i + 1])
                                              for i in range(4)]))
        else:
            import torch
            from pydens_tpu_torch.utils.criteria import mse_loss
            loss_fn = s._build_loss_fn((("equation", 1.0),), mse_loss,
                                       use_plan=True)
            theta = loss_fn.spec.flatten(s.model.params).detach()

            def value(pts):
                return float(loss_fn(theta, torch.from_numpy(pts)).detach())
        sampler = w3_sampler(10)
        batch = cs.W3_FIT["batch_size"]
        return float(np.mean([value(np.asarray(sampler.sample(batch),
                                               np.float32))
                              for _ in range(cs.MSE_BATCHES)]))

    truth = cs._stiff_exact(XS.astype(np.float64))
    values = []
    for seed in seeds:
        s = solver(seed)
        t0 = time.perf_counter()
        if arm.startswith("w3"):
            s.fit(sampler=w3_sampler(), progress=False, **ARMS[arm])
        else:
            s.fit(progress=False, **ARMS[arm])
        wall = time.perf_counter() - t0
        if arm in ("uniform", "adaptive"):
            value = float(np.mean(s.residual(XS)))
            metric = "mean_residual"
        elif arm.startswith("w3"):
            value = plain_mse(s)
            metric = "plain_mse_50_batches"
        else:
            value = float(np.max(np.abs(s.predict(XS).ravel() - truth)))
            metric = "max_error"
        values.append(value)
        print(json.dumps({"package": pkg_name, "arm": arm, "seed": seed,
                          metric: value, "wall_s": wall}), flush=True)
    return values


def main(pkg_name, seeds=cs.COLLOCATION_SEEDS, only=None):
    results = {arm: study(pkg_name, arm, list(seeds)) for arm in ARMS
               if only is None or arm == only}
    print(json.dumps({"package": pkg_name, "summary": {
        arm: {"median": float(np.median(v)), "max": float(np.max(v)),
              "values": v} for arm, v in results.items()},
        "adaptive_over_uniform": [a / u for a, u in
                                  zip(results.get("adaptive", []),
                                      results.get("uniform", []))]}),
          flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args else "torch",
         range(int(args[1]), int(args[2])) if len(args) > 2
         else cs.COLLOCATION_SEEDS,
         args[3] if len(args) > 3 else None)
