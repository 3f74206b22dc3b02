"""An example's numbers over seeds: ``examples/<name>.py`` under
pydens_tpu on the CPU (the reference), or ``examples_torch/<name>.py``
under pydens_tpu_torch, with every ``Solver`` the file builds given each
seed in turn in place of its own.  It tells an example whose own assert
holds at its seed only by that seed's draw from one that holds over seeds.

    python tests/example_seed_study.py jax 12_biharmonic_beam 0 6
    python tests/example_seed_study.py torch_cuda 12_biharmonic_beam 0 6
    python tests/example_seed_study.py torch_cuda_derived \
        12_biharmonic_beam,16_burgers_shock 0 6
    python tests/example_seed_study.py jax_from_torch 16_burgers_shock 3 4
    python tests/example_seed_study.py jax_from_torch 16_burgers_shock 3 4 7

``torch`` runs the port on the CPU, ``torch_cuda`` on the card, and
``torch_cuda_derived`` on the card with the sampling generator seeded as
on the CPU (``solver._sampling_seed``'s child of the seed) rather than
with the seed itself.  ``jax_from_torch`` runs pydens_tpu on the CPU from
the port's initial parameters of each seed: each Solver the JAX file
builds takes those of the port's file's Solver built in the same order
(drawn on the CPU, as on the card), so a fit that goes wrong from one
draw can be told from a port that fits differently.  The example's other
draws (batches, candidate pools) stay each package's own; a fifth
argument adds that much to the seed of pydens_tpu's own draws, to see one
start under other draws.  Prints one
JSON line per example and seed: the numbers of each line the file
printed, whether its own asserts held (and the failing assert's
arguments), each fit's losses, the seconds; then one line per example
with how many seeds held.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _package(pkg_name):
    if pkg_name in ("jax", "jax_from_torch"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import pydens_tpu
        return pydens_tpu, ROOT / "examples"
    import pydens_tpu_torch
    if pkg_name == "torch_cuda_derived":
        import torch
        from pydens_tpu_torch import solver as solver_module
        derive = solver_module._sampling_seed
        solver_module._sampling_seed = (
            lambda seed, device: derive(seed, torch.device("cpu")))
    return pydens_tpu_torch, ROOT / "examples_torch"


def torch_initial_params(name, seed):
    """The initial parameters (numpy trees) of each Solver that
    examples_torch/``name`` builds at ``seed`` on the CPU, in order: its
    main() with every fit skipped (its asserts then fail, and are
    ignored)."""
    import pydens_tpu_torch as tpkg
    base, params = tpkg.Solver, []

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            kwargs["seed"] = seed
            super().__init__(*args, **kwargs)
            params.append(_numpy_tree(self.model.params))

        def fit(self, *args, **kwargs):
            return None

    tpkg.Solver = Recorded
    try:
        mod = _module(ROOT / "examples_torch", name)
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                mod.main("cpu")
            except AssertionError:
                pass
    finally:
        tpkg.Solver = base
    return params


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _module(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(pkg, folder, name, seed, device, start=None):
    """examples' ``name`` with every Solver at ``seed`` (and, given
    ``start``, the initial parameters of the i-th Solver built
    ``start[i]``): the printed lines' numbers, whether the file's asserts
    held, each fit's steps and first, least and last loss, the
    seconds."""
    base = pkg.Solver
    built, fits = [], []

    class Seeded(base):
        def __init__(self, *args, **kwargs):
            kwargs["seed"] = seed
            super().__init__(*args, **kwargs)
            if start is not None:
                import jax
                import jax.numpy as jnp
                own = self.model.params
                given = start[len(built)]
                assert (jax.tree.structure(own) == jax.tree.structure(given)
                        and [a.shape for a in jax.tree.leaves(own)]
                        == [a.shape for a in jax.tree.leaves(given)])
                self.model.params = jax.tree.map(jnp.asarray, given)
            built.append(self)

        def fit(self, *args, **kwargs):
            n0 = len(self.losses)
            out = super().fit(*args, **kwargs)
            losses = [float(v) for v in self.losses[n0:]]
            fits.append(dict(steps=len(losses), first_loss=losses[0],
                             min_loss=min(losses), last_loss=losses[-1]))
            return out

    pkg.Solver = Seeded
    try:
        mod = _module(folder, name)
        out, failed = io.StringIO(), None
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            try:
                mod.main() if device is None else mod.main(device)
            except AssertionError as err:
                failed = [repr(a) for a in err.args]
        seconds = time.perf_counter() - t0
    finally:
        pkg.Solver = base
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return dict(held=failed is None, failed_assert=failed, fits=fits,
                printed={ln.split(":")[0].strip(): [
                    float(x) for x in NUMBER.findall(ln.split(":", 1)[-1])]
                    for ln in lines}, seconds=seconds)


def main(pkg_name, names, seeds, offset=0):
    pkg, folder = _package(pkg_name)
    device = {"jax": None, "jax_from_torch": None,
              "torch": "cpu"}.get(pkg_name, "cuda")
    for name in names:
        held = []
        for seed in seeds:
            start = (torch_initial_params(name, seed)
                     if pkg_name == "jax_from_torch" else None)
            row = run(pkg, folder, name, seed + offset, device, start)
            held.append(row["held"])
            print(json.dumps({"package": pkg_name, "example": name,
                              "seed": seed, "draws_seed": seed + offset,
                              **row}), flush=True)
        print(json.dumps({"package": pkg_name, "example": name,
                          "seeds": list(seeds), "held": sum(held),
                          "of": len(held)}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0], args[1].split(","), range(int(args[2]), int(args[3])),
         int(args[4]) if len(args) > 4 else 0)
