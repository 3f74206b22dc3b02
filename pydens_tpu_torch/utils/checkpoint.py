"""Checkpoint / resume, counterpart of ``pydens_tpu/utils/checkpoint.py``.

The training state of a Solver — the parameter tree (network,
``log_scale`` and V variables), the optimizer state, the losses, the step
counter, the sampling generator's state, the fit history, the condition
modes, the frozen names and a balanced fit's live term weights — in a
format that needs neither jax nor flax: a ``numpy.savez`` archive of
arrays, with a format tag and one JSON member for what is not an array.
numpy has no bfloat16: a bfloat16 solver's parameters and optimizer state
are stored as float32 (exact) with the dtype recorded, and load into the
solver's bfloat16 leaves.  It is written to a temporary file and renamed
into place, so a crash mid-write keeps the previous checkpoint.  Enough
state is kept that a resumed run continues the saving run's next fit bit
for bit on the same device.
"""

import json
import os
import zipfile

import numpy as np
import torch

from ..ops.tokens import to_host
from ..solver import _tree_leaves

__all__ = ["save_solver", "load_solver"]

_FORMAT = "pydens_tpu_torch checkpoint 1"


def _host(t):
    return to_host(t) if torch.is_tensor(t) else np.asarray(t)


def save_solver(solver, path, *, params=None, opt_state=None, losses=None,
                step_counter=None, balanced_weights=None):
    """Write ``solver``'s training state to ``path``.  The keyword
    overrides let ``fit`` snapshot its own buffers mid-fit
    (``checkpoint_path=``) without changing the solver;
    ``balanced_weights`` (a list, while loss balancing runs) is kept, for
    ``fit(loss_terms=dict(zip(names, solver.last_balanced_weights)))``
    after a load."""
    params = solver.model.params if params is None else params
    opt_state = solver._opt_state if opt_state is None else opt_state
    losses = solver.losses if losses is None else losses
    step_counter = (solver._step_counter if step_counter is None
                    else step_counter)
    arrays = {"format": np.array(_FORMAT)}
    for keys, leaf in _tree_leaves(params):
        arrays["params/" + "/".join(keys)] = _host(leaf)
    for name, value in (opt_state or {}).items():
        arrays["opt_state/" + name] = _host(value)
    arrays["losses"] = np.asarray(losses, np.float32)
    arrays["step_counter"] = np.int64(step_counter)
    arrays["generator_state"] = _host(solver._generator.get_state())
    arrays["meta"] = np.array(json.dumps({
        "history": solver.history,
        "cond_modes": solver.model._cond_modes,
        "frozen_layers": sorted(solver.model._frozen_layers),
        "frozen_variables": sorted(solver.model._frozen_variables),
        "generator_device": solver.device.type,
        "balanced_weights": balanced_weights,
        "dtype": str(solver.model.dtype),
    }))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load_solver(solver, path):
    """Restore a checkpoint of :func:`save_solver` into ``solver``, which
    must have the same model configuration.  The optimizer state waits in
    ``solver._pending_opt_state`` for the next fit, which grafts it onto its
    optimizer; the generator state is restored when the checkpoint was
    written on the same kind of device."""
    try:
        with np.load(path, allow_pickle=False) as archive:
            data = {name: archive[name] for name in archive.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        data = {}
    if str(data.get("format", "")) != _FORMAT:
        raise ValueError(f"{path} is not a pydens_tpu_torch checkpoint")

    current = dict(_tree_leaves(solver.model.params))
    saved = {tuple(name.split("/")[1:]): value for name, value in data.items()
             if name.startswith("params/")}
    problem = None
    if set(saved) != set(current):
        problem = (f"parameters {sorted('/'.join(k) for k in saved)} vs "
                   f"{sorted('/'.join(k) for k in current)}")
    else:
        problem = next((f"shape mismatch at {'/'.join(keys)}: "
                        f"{tuple(leaf.shape)} vs {tuple(saved[keys].shape)}"
                        for keys, leaf in current.items()
                        if tuple(saved[keys].shape) != tuple(leaf.shape)),
                       None)
    meta = json.loads(str(data["meta"]))
    saved_dtype = meta.get("dtype", str(torch.float32))
    if problem is None and saved_dtype != str(solver.model.dtype):
        problem = f"dtype {saved_dtype} vs {solver.model.dtype}"
    if problem is not None:
        raise ValueError(f"checkpoint at {path} does not match this solver's "
                         f"model configuration: {problem}")
    with torch.no_grad():
        for keys, leaf in current.items():
            leaf.copy_(torch.from_numpy(saved[keys]))
    solver.losses = data["losses"].tolist()
    solver._step_counter = int(data["step_counter"])
    if meta["generator_device"] == solver.device.type:
        solver._generator.set_state(torch.from_numpy(data["generator_state"]))
    solver.history = meta["history"]
    solver.model._cond_modes = dict(meta["cond_modes"])
    solver.model._frozen_layers = set(meta["frozen_layers"])
    solver.model._frozen_variables = set(meta["frozen_variables"])
    # Term order: the equation first, then the constraints.
    solver.last_balanced_weights = meta.get("balanced_weights")
    opt_state = {name[len("opt_state/"):]: value
                 for name, value in data.items()
                 if name.startswith("opt_state/")}
    solver._pending_opt_state = opt_state or None
