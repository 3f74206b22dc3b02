"""Notebook cells as plain JSON (nbformat 4.5), written and read with the
standard library alone: the generators of this folder, its test and
``chip_smoke.py`` run where ``nbformat`` is not installed."""

import json

KERNELSPEC = {"display_name": "Python 3", "language": "python",
              "name": "python3"}


def md(text):
    return {"cell_type": "markdown", "metadata": {}, "source": text}


def code(text):
    return {"cell_type": "code", "execution_count": None, "metadata": {},
            "outputs": [], "source": text.strip()}


def write(cells, path):
    """Write ``cells`` as a notebook at ``path`` (sources as lists of
    lines, each cell a stable id from its index)."""
    nb = {"cells": [dict(c, id=f"cell-{i:02d}",
                         source=c["source"].splitlines(keepends=True))
                    for i, c in enumerate(cells)],
          "metadata": {"kernelspec": KERNELSPEC},
          "nbformat": 4, "nbformat_minor": 5}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(nb, f, indent=1, ensure_ascii=False)
        f.write("\n")
    print("wrote", path)


def read(path):
    """The notebook's cells as ``(cell_type, source)`` pairs."""
    with open(path, encoding="utf-8") as f:
        nb = json.load(f)
    return [(c["cell_type"], "".join(c["source"])) for c in nb["cells"]]
