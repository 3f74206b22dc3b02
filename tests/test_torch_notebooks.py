"""The port's tutorial notebooks (tutorials_torch/) against tutorials/.

(a) Each generator rebuilds its committed notebook.  (b) Each port
notebook corresponds to its pydens_tpu notebook cell for cell: code equal
once the import lines name ``pydens_tpu``, the ``DEVICE`` line is gone and
every ``device=DEVICE`` argument is dropped; markdown equal up to the
package name; the only exceptions are ``DIFFERENCES``.  (c) Every code
cell of both notebooks runs on the CPU (``DEVICE = 'cpu'``) with each
``niters=N`` cut to ``min(N, 60)`` (loss balancing's window of 50 still
fires once); an AST pass removes the notebooks' ``assert`` statements,
since their bounds hold at the full budgets only: they bind verbatim on
the card (``chip_smoke.py --notebooks``) and in the ``slow`` test (d),
which runs both notebooks verbatim on the CPU, as tests/test_tutorial.py
runs tutorials/."""

import ast
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from one_thread import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tutorials_torch"
sys.path.insert(0, str(PORT))
from notebook_json import read  # noqa: E402

NOTEBOOKS = {"1_solving_pdes.ipynb": "make_tutorial.py",
             "2_torch_examples.ipynb": "make_examples_nb.py"}
DEVICE_LINE = "DEVICE = None  # the card; 'cpu' runs on the CPU"
CUT_NITERS = 60

# (notebook, cell index) -> why the port's cell differs from pydens_tpu's
DIFFERENCES = {
    ("1_solving_pdes.ipynb", 0):
        "the port trains through captured CUDA graphs, not one XLA loop",
    ("1_solving_pdes.ipynb", 2): "pdt.cos mirrors torch.cos, not jnp.cos",
    ("1_solving_pdes.ipynb", 21):
        "the artifact is torch.export's, served with torch alone",
    ("1_solving_pdes.ipynb", 22):
        "the loaded function returns a torch tensor: .cpu() before "
        "np.asarray",
    ("1_solving_pdes.ipynb", 29):
        "ranks joined over NCCL (one a card), not chips over ICI",
    ("1_solving_pdes.ipynb", 30):
        "no shape buckets, no pydens_tpu.numpy shim, npz checkpoints",
    ("2_torch_examples.ipynb", 2):
        "the adapter takes a torch.nn.Module: module_model, not flax_model",
}


def _generator(name):
    path = PORT / NOTEBOOKS[name]
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _normalized(kind, source):
    """A port cell as its pydens_tpu twin would read."""
    if kind == "markdown":
        return source.replace("pydens_tpu_torch", "pydens_tpu")
    lines = []
    for line in source.replace("\n\n" + DEVICE_LINE, "").splitlines():
        if re.match(r"(import|from) pydens_tpu_torch\b", line):
            line = line.replace("pydens_tpu_torch", "pydens_tpu")
        lines.append(line)
    return re.sub(r",\s*device=DEVICE", "", "\n".join(lines))


@pytest.mark.parametrize("name", list(NOTEBOOKS))
def test_generator_rebuilds_the_notebook(name):
    cells = [(c["cell_type"], c["source"]) for c in _generator(name).CELLS]
    assert cells == read(PORT / name)


@pytest.mark.parametrize("name", list(NOTEBOOKS))
def test_notebook_corresponds_to_pydens_tpus(name):
    port, jax_side = read(PORT / name), read(REPO / "tutorials" / name)
    assert [k for k, _ in port] == [k for k, _ in jax_side]
    differ = {i for i, ((kind, src), (_, want)) in enumerate(zip(port,
                                                                 jax_side))
              if _normalized(kind, src) != want}
    assert differ == {i for n, i in DIFFERENCES if n == name}
    code = [src for kind, src in port if kind == "code"]
    assert code[0].splitlines()[-1] == DEVICE_LINE
    assert not any("cuda.is_available" in src for src in code)
    calls = sum(len(re.findall(r"\b(Solver|load_exported)\(", src))
                for src in code)
    assert calls == sum(src.count("device=DEVICE") for src in code) > 0


class _CutForTheCPU(ast.NodeTransformer):
    """``DEVICE = 'cpu'``, each ``niters=N`` as ``min(N, 60)``, and every
    ``assert`` removed."""

    def visit_Assert(self, node):
        return ast.Pass()

    def visit_Assign(self, node):
        if [getattr(t, "id", None) for t in node.targets] == ["DEVICE"]:
            node.value = ast.Constant("cpu")
        return node

    def visit_keyword(self, node):
        if node.arg == "niters" and isinstance(node.value, ast.Constant):
            node.value = ast.Constant(min(node.value.value, CUT_NITERS))
        return self.generic_visit(node)


@pytest.mark.parametrize("name", list(NOTEBOOKS))
def test_every_cell_runs_on_the_cpu(name, monkeypatch):
    from pydens_tpu_torch import Solver
    fitted = []
    fit = Solver.fit

    def recorded(self, *args, **kwargs):
        fitted.append(self)
        return fit(self, *args, **kwargs)
    monkeypatch.setattr(Solver, "fit", recorded)
    namespace, ran = {}, 0
    cells = [src for kind, src in read(PORT / name) if kind == "code"]
    for i, src in enumerate(cells):
        tree = _CutForTheCPU().visit(ast.parse(src))
        ast.fix_missing_locations(tree)
        exec(compile(tree, f"{name} code cell {i}", "exec"),  # noqa: S102
             namespace)
        ran += 1
    assert ran == len(cells) and namespace["DEVICE"] == "cpu"
    assert "solver" in namespace
    if name.startswith("1_"):
        assert "adaptive" in namespace
    assert fitted and all(len(s.losses) and np.isfinite(s.losses).all()
                          for s in fitted)


def test_device_none_is_the_card(monkeypatch):
    # Verbatim, a notebook asks for the card: without one its first Solver
    # and load_exported raise and say how to ask for the CPU.
    import torch
    import pydens_tpu_torch as pdt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cells = [src for kind, src in read(PORT / "1_solving_pdes.ipynb")
             if kind == "code"]
    namespace = {}
    exec(cells[0], namespace)  # noqa: S102
    assert namespace["DEVICE"] is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exec(cells[1], namespace)  # noqa: S102
    blob = pdt.Solver(lambda f, x: pdt.D(f, x), ndims=1, layout="fa f",
                      features=[4, 1], device="cpu").export()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdt.load_exported(blob, device=namespace["DEVICE"])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(NOTEBOOKS))
def test_notebook_runs_verbatim_on_the_cpu(name):
    source = "\n\n".join(src for kind, src in read(PORT / name)
                         if kind == "code")
    source = source.replace(DEVICE_LINE, "DEVICE = 'cpu'")
    namespace = {}
    exec(compile(source, str(PORT / name), "exec"), namespace)  # noqa: S102
    assert "solver" in namespace
    if name.startswith("1_"):
        assert "adaptive" in namespace
