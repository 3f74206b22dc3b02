"""The port's twin of tests/test_dtype.py: a bfloat16 Solver trains end to
end (max error < 0.2 on the tutorial ODE after 400 steps) and float32 is
much tighter; its results (``predict``, ``predict_all``, ``predict_std``,
``residual``, ``predict_grad``, ``predict_grid``, ``Field.predict``) come
back as float32 numpy arrays (numpy has no bfloat16; every bfloat16 value
is a float32 value), and ``save``/``load`` round-trips it: stored as
float32 with the dtype recorded, loaded back into bfloat16 leaves whose
predictions equal the saved solver's bit for bit."""

import functools

import numpy as np
import pytest
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import D, Solver


def _ode(f, x):
    return D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)


def _solver(dtype, **kw):
    return Solver(_ode, ndims=1, initial_condition=.5, activation="Tanh",
                  layout="fafaf", features=[12, 10, 1], seed=0, dtype=dtype,
                  device="cpu", **kw)


def _max_err(solver):
    xs = np.linspace(0, 1, 50)
    preds = solver.predict(xs).ravel()
    return float(np.max(np.abs(preds - (np.sin(2 * np.pi * xs) + .5))))


@functools.lru_cache(maxsize=None)
def _fitted(dtype):
    """test_dtype.py's fit: 400 steps at batch 400, lr 0.02 (one fit a
    dtype serves both tests)."""
    s = _solver(dtype)
    s.fit(niters=400, batch_size=400, lr=0.02, progress=False)
    return s


def test_bfloat16_end_to_end():
    solver = _fitted(torch.bfloat16)
    assert solver.params["net"]["fc1"]["w"].dtype == torch.bfloat16
    assert solver.predict(np.linspace(0, 1, 5)).dtype == np.float32
    assert _max_err(solver) < 0.2  # coarse: bf16 mantissa


def test_float32_much_tighter_than_bf16():
    errs = {dtype: _max_err(_fitted(dtype))
            for dtype in (torch.float32, torch.bfloat16)}
    assert errs[torch.float32] * 3 < errs[torch.bfloat16], errs


def test_bfloat16_results_are_float32():
    # Each results method of a bfloat16 solver returns float32 arrays of
    # its float32 shape, equal to its bfloat16 values (exact widening).
    s = _solver(torch.bfloat16, n_models=2)
    s.fit(niters=5, batch_size=64, progress=False)
    xs = np.linspace(0, 1, 7)
    out = {"predict": s.predict(xs), "predict_all": s.predict_all(xs),
           "predict_std": s.predict_std(xs), "residual": s.residual(xs),
           "predict_grad": s.predict_grad(xs),
           "predict_grid": s.predict_grid(xs)}
    shapes = {"predict": (7, 1), "predict_all": (2, 7, 1),
              "predict_std": (7, 1), "residual": (7, 1),
              "predict_grad": (7, 1), "predict_grid": (7, 1)}
    for name, arr in out.items():
        assert isinstance(arr, np.ndarray) and arr.dtype == np.float32, name
        assert arr.shape == shapes[name], name
        assert np.isfinite(arr).all(), name
    raw = s._predict_raw((xs,))
    np.testing.assert_array_equal(out["predict_all"],
                                  raw.float().numpy())
    field = pdt.Field("q", features=[4, 1])
    f = Solver(lambda u, x: D(u, x) - field(x), ndims=1, initial_condition=0,
               layout="fa f", features=[8, 1], dtype=torch.bfloat16,
               device="cpu")
    assert f.params["variables"]["q.fc1.w"].dtype == torch.bfloat16
    assert field.predict(f, xs).dtype == np.float32


@pytest.mark.parametrize("n_models", [1, 2])
def test_bfloat16_save_load_round_trip(tmp_path, n_models):
    # Stored as float32 with the dtype recorded; loaded into a bfloat16
    # solver of another seed, its leaves and predictions equal the saved
    # solver's bit for bit, its next fit continues from the same optimizer
    # state; a float32 solver refuses the checkpoint.
    s = _solver(torch.bfloat16, n_models=n_models)
    s.fit(niters=20, batch_size=64, progress=False)
    path = str(tmp_path / "bf16.npz")
    s.save(path)
    with np.load(path) as archive:
        assert archive["params/net/fc1/w"].dtype == np.float32
    s2 = _solver(torch.bfloat16, n_models=n_models)
    s2.reset(seed=5)
    s2.load(path)
    for (_, a), (_, b) in zip(sorted(_leaves(s.params)),
                              sorted(_leaves(s2.params))):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.detach(), b.detach())
    xs = np.linspace(0, 1, 33)
    np.testing.assert_array_equal(s2.predict(xs), s.predict(xs))
    s.fit(niters=3, batch_size=64, progress=False, optimizer=None)
    s2.fit(niters=3, batch_size=64, progress=False, optimizer="Adam")
    assert s2.losses[-3:] == s.losses[-3:]
    with pytest.raises(ValueError, match="dtype"):
        _solver(torch.float32, n_models=n_models).load(path)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]
