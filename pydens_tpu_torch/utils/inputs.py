"""The points a user passes to ``Solver.predict`` and the model call, as
one ``(N, ndims + nparams)`` array: mixed per-column inputs with the
reference's quirks, or one stacked array or tensor."""

import numpy as np

__all__ = ["is_number", "reshape_and_concat", "normalize_inputs"]


def is_number(x):
    return isinstance(x, (int, float, np.integer, np.floating))


def reshape_and_concat(tensors):
    """Cast, reshape and concatenate mixed inputs to an ``(N, D)`` float32
    array, with the reference's quirks (``model_torch.py:327-362``): batch
    size is the max element count; scalars are tiled; numpy arrays whose
    size mismatches the batch are tiled from their first element; torch
    tensors must match; lists become columns."""
    xs, torch_origin = [], []
    for x in tensors:
        was_torch = hasattr(x, "detach")
        if was_torch:
            x = x.detach().cpu().numpy()
        xs.append(x)
        torch_origin.append(was_torch)
    sizes = ([int(np.prod(x.shape)) for x in xs
              if isinstance(x, np.ndarray)]
             + [int(np.prod(np.asarray(x).shape)) for x in xs
                if isinstance(x, (tuple, list))])
    batch_size = int(np.max(sizes)) if sizes else 1
    cols = []
    for x, was_torch in zip(xs, torch_origin):
        if is_number(x):
            col = np.tile(np.float32(x), (batch_size, 1))
        elif isinstance(x, np.ndarray):
            if x.size != batch_size:
                if was_torch:
                    raise ValueError(
                        f"torch tensor with {x.size} elements cannot be "
                        f"concatenated with batch size {batch_size} "
                        "(sizes must match)")
                x = np.tile(np.ravel(x)[0], (batch_size, 1))
            col = np.asarray(x, np.float32).reshape(batch_size, 1)
        elif isinstance(x, (list, tuple)):
            col = np.asarray(x, np.float32).reshape(-1, 1)
        else:
            raise TypeError(f"cannot interpret input of type {type(x)!r}")
        cols.append(col)
    return np.concatenate(cols, axis=1).astype(np.float32)


def normalize_inputs(xs, total):
    """Mixed per-column inputs (reference semantics) or one stacked
    ``(N, total)`` array or tensor on any device, as a float32 numpy
    array."""
    if (len(xs) == 1 and hasattr(xs[0], "ndim") and xs[0].ndim == 2
            and xs[0].shape[1] == total > 1):
        x = xs[0]
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        xs_concat = np.asarray(x, np.float32)
    else:
        xs_concat = reshape_and_concat(xs)
    if xs_concat.shape[1] != total:
        raise ValueError(
            f"received {xs_concat.shape[1]} coordinate columns but the "
            f"problem has ndims+nparams={total}")
    return xs_concat

