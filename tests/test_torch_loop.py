"""The loop features of Solver.fit against pydens_tpu: the callback's
arguments and its stop, a cosine-schedule fit, reset(), a profile_dir
trace, and the fit step's closure over its cached buffers (the CPU runs it
eagerly; tests/test_torch_graphs_gpu.py replays it as a CUDA graph)."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils import schedules


class _FixedBatch:
    """Host-protocol sampler (no device path) returning fixed points."""

    def __init__(self, pts):
        self.pts = pts

    def sample(self, size):
        return self.pts[:size]


def _inverse(pdt):
    def odevar(f, x):
        return (pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
                + pdt.V("new_var", data=np.array([1.0])))
    return odevar, dict(ndims=1, initial_condition=1,
                        constraints=lambda f, x: f(np.array([0.5])))


def _pair():
    """w5's JAX solver and the port's with the JAX parameters copied."""
    eq, kw = _inverse(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    eq, kw = _inverse(tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


PTS = np.random.default_rng(11).uniform(size=(128, 1)).astype(np.float32)


def test_callback_arguments_and_stop_match_jax():
    # Fixed batch, copied theta, chunks of 7: the callback sees the same
    # global iterations and the same chunk losses (float32 arrays, rtol
    # 1e-4: a few Adam steps from the same point) in both, and a truthy
    # return at the third chunk stops both there.
    seen = {"jax": [], "port": []}

    def make(key):
        def cb(iteration, losses):
            seen[key].append((iteration, np.array(losses)))
            return iteration >= 21
        return cb

    js, ts = _pair()
    fit = dict(niters=40, batch_size=len(PTS), lr=0.01, progress=False,
               sampler=_FixedBatch(PTS), resample=False, chunk_size=7)
    js.fit(callback=make("jax"), **fit)
    ts.fit(callback=make("port"), **fit)
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["jax"]] == [
        7, 14, 21]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (7,)
        np.testing.assert_allclose(a, b, rtol=1e-4)
    assert len(ts.losses) == len(js.losses) == 21
    assert ts.history[-1]["niters"] == js.history[-1]["niters"] == 21


def test_cosine_schedule_fit_tracks_jax():
    # w5's first phase on a fixed batch with lr = a cosine decay from 0.1
    # over the fit (the port's schedule and optax's), 16 steps: rtol 1e-3
    # on the losses, as the Adam two-phase fit; the same history keys.
    js, ts = _pair()
    fit = dict(niters=16, batch_size=len(PTS), progress=False,
               sampler=_FixedBatch(PTS), resample=False)
    js.fit(lr=optax.cosine_decay_schedule(0.1, 16), **fit)
    ts.fit(lr=schedules.cosine_decay_schedule(0.1, 16), **fit)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-3)
    assert set(ts.history[-1]) == set(js.history[-1])
    assert ts.history[-1]["lr"] == js.history[-1]["lr"] == "schedule"


def _theta(solver):
    return torch.cat([p.detach().reshape(-1)
                      for p in solver.model.parameters()])


def test_reset_equals_a_fresh_solver():
    # reset(seed) gives the parameters and V variables of a new Solver of
    # that seed, clears the losses, history, optimizer and counter, and
    # keeps the cached fit step; its next fit equals the fresh solver's,
    # bit for bit.  reset() without a seed draws new parameters.
    eq, kw = _inverse(tpdt)
    s = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    s.fit(niters=30, batch_size=64, lr=0.1, progress=False)
    cached = dict(s._step_cache)
    s.reset(seed=4)
    fresh = tpdt.Solver(eq, seed=4, device="cpu", **kw)
    assert torch.equal(_theta(s), _theta(fresh))
    assert s.params["variables"]["new_var"].item() == 1.0
    assert (s.losses, s.history, s._opt, s._opt_state, s._step_counter) == (
        [], [], None, None, 0)
    assert s._step_cache == cached
    for solver in (s, fresh):
        solver.fit(niters=30, batch_size=64, lr=0.1, progress=False)
    assert s.losses == fresh.losses
    assert torch.equal(_theta(s), _theta(fresh))
    assert list(s._step_cache.values())[0] is list(cached.values())[0]
    before = _theta(s)
    s.reset()
    assert not torch.equal(_theta(s), before)
    assert not torch.equal(_theta(s), _theta(tpdt.Solver(eq, seed=4,
                                                         device="cpu", **kw)))


def test_profile_dir_writes_a_trace(tmp_path):
    eq, kw = _inverse(tpdt)
    s = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    out = tmp_path / "prof"
    s.fit(niters=6, batch_size=32, progress=False, chunk_size=3,
          profile_dir=str(out))
    (name,) = os.listdir(out)
    assert name.startswith("fit_") and name.endswith(".pt.trace.json")
    trace = json.loads((out / name).read_text())
    ops = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in ops or "aten::addmm" in ops
    assert len(s.losses) == 6


def test_step_closure_reads_its_row_and_reuses_its_buffers():
    # The step reads the points row and writes the loss slot the device
    # index picks, on buffers allocated once per configuration: a second
    # fit of the same configuration reuses them, a new batch size builds
    # another step.  With lr 0 theta stays put, so each loss is the loss
    # function at its own row.
    eq, kw = _inverse(tpdt)
    s = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    s.fit(niters=5, batch_size=16, optimizer="SGD", lr=0.0, progress=False)
    (step,) = s._step_cache.values()
    ptrs = (step.theta.data_ptr(), step.points.data_ptr(),
            step.losses.data_ptr(), step.state["count"].data_ptr())
    assert int(step.index) == 5 and step.points.shape == (5, 16, 1)
    assert int(step.state["count"]) == 5
    theta = step.theta.detach()
    assert s.losses == [float(step.loss_fn(theta, step.points[k]))
                        for k in range(5)]
    s.fit(niters=5, batch_size=16, optimizer="SGD", lr=0.0, progress=False)
    assert list(s._step_cache.values()) == [step]
    assert ptrs == (step.theta.data_ptr(), step.points.data_ptr(),
                    step.losses.data_ptr(), step.state["count"].data_ptr())
    s.fit(niters=5, batch_size=8, optimizer="SGD", lr=0.0, progress=False)
    assert len(s._step_cache) == 2
    assert step.eager_steps == 10 and step.replays == 0 and step.graph is None


def test_host_values_pass_through_on_the_cpu():
    # as_device is torch.as_tensor on the CPU, inside staging or not (the
    # card's staging is held by tests/test_torch_graphs_gpu.py).
    from pydens_tpu_torch.ops.tokens import as_device, staging
    a = np.array([0.5, 1.5])
    assert torch.equal(as_device(a, "cpu"), torch.as_tensor(a))
    store = {}
    with staging(store):
        x = as_device(a, "cpu", torch.float32)
        assert x.dtype == torch.float32 and not store
        assert as_device(x, "cpu") is x


def test_a_step_that_raises_keeps_the_last_whole_chunk():
    # An error inside a chunk (here the equation, on its 7th step; on the
    # card a capture that fails) puts theta and the optimizer state back
    # as they were before that chunk: the fit commits the first chunk's 4
    # steps, as many losses and a step counter of 4, and nothing of the
    # second.
    calls = []

    def flaky(f, x):
        calls.append(1)
        if len(calls) == 8:   # the discovery run, then steps 1..7
            raise ValueError("boom")
        return tpdt.D(f, x) - 2 * np.pi * tpdt.cos(2 * np.pi * x)

    s = tpdt.Solver(flaky, ndims=1, initial_condition=.5, seed=0,
                    device="cpu")
    with pytest.raises(ValueError, match="boom"):
        s.fit(niters=12, batch_size=32, chunk_size=4, progress=False)
    ref = tpdt.Solver(lambda f, x: tpdt.D(f, x) - 2 * np.pi * tpdt.cos(
        2 * np.pi * x), ndims=1, initial_condition=.5, seed=0, device="cpu")
    ref.fit(niters=4, batch_size=32, chunk_size=4, progress=False)
    assert s._step_counter == 4 and s.losses == ref.losses
    assert torch.equal(_theta(s), _theta(ref))
    assert s._opt_state["count"] == 4
