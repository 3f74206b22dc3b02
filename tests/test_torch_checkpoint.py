"""Checkpoint / resume of pydens_tpu_torch, mirroring tests/test_checkpoint.py
(pydens_tpu's): a round trip, a bit-exact resume on the CPU, V variables,
a mismatched model and a foreign file rejected with pydens_tpu's messages,
auto-checkpoints that survive a raising callback, checkpoint_every with the
final save, the save at an early callback stop, and a balanced fit's term
weights (``Solver.last_balanced_weights``)."""

import json

import numpy as np
import pytest
import torch

from pydens_tpu_torch import D, Solver, V


def _ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)


def _solver(seed, **kw):
    kw = dict(dict(initial_condition=.5), **kw)
    return Solver(_ode, ndims=1, seed=seed, device="cpu", **kw)


def test_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    s1 = _solver(0)
    s1.fit(niters=100, batch_size=128, progress=False)
    preds = s1.predict(np.linspace(0, 1, 10))
    s1.save(path)

    s2 = _solver(1)
    s2.load(path)
    np.testing.assert_allclose(s2.predict(np.linspace(0, 1, 10)), preds,
                               rtol=1e-6)
    assert len(s2.losses) == 100 and s2.losses == s1.losses
    # The history goes through JSON: its tuples come back as lists.
    assert s2._step_counter == 100
    assert s2.history == json.loads(json.dumps(s1.history))


def test_resume_continues_bit_exactly(tmp_path):
    # Parameters, optimizer state and the sampling generator's state are
    # all in the file: the loaded solver's next fit is the saving solver's
    # next fit, bit for bit (CPU).
    path = str(tmp_path / "ckpt.npz")
    s1 = _solver(0)
    s1.fit(niters=150, batch_size=128, progress=False, chunk_size=60)
    s1.save(path)
    s1.fit(niters=100, batch_size=128, progress=False, chunk_size=60,
           optimizer=None)

    s2 = _solver(2)
    s2.load(path)
    s2.fit(niters=100, batch_size=128, progress=False, chunk_size=60)
    assert len(s2.losses) == 250
    assert s2.losses == s1.losses
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(a, b)
    assert s2.losses[-1] < s2.losses[0]


def test_checkpoint_preserves_v_variables(tmp_path):
    path = str(tmp_path / "ckpt.npz")

    def odevar(f, x):
        return D(f, x) + V("c", data=np.array([1.5]))

    s1 = Solver(odevar, ndims=1, seed=0, device="cpu")
    s1.fit(niters=20, batch_size=32, progress=False)
    v = s1.params["variables"]["c"].detach().numpy().copy()
    assert v != 1.5
    s1.save(path)

    s2 = Solver(odevar, ndims=1, seed=3, device="cpu")
    s2.load(path)
    np.testing.assert_allclose(s2.params["variables"]["c"].detach().numpy(),
                               v)


def test_mismatched_config_rejected(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    s1 = Solver(_ode, ndims=1, seed=0, device="cpu")
    s1.save(path)
    s2 = Solver(_ode, ndims=1, features=[7, 7, 1], layout="fafaf", seed=0,
                device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        s2.load(path)


def test_bad_file_rejected(tmp_path):
    s = Solver(_ode, ndims=1, seed=0, device="cpu")
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a pydens_tpu_torch checkpoint"):
        s.load(str(junk))
    other = tmp_path / "other.npz"
    np.savez(other, losses=np.zeros(3))
    with pytest.raises(ValueError, match="not a pydens_tpu_torch checkpoint"):
        s.load(str(other))


def test_incompatible_optimizer_state_warns_and_trains(tmp_path):
    # Adam's moments cannot graft onto SGD's state: the next fit warns,
    # keeps its own fresh state, and trains (pydens_tpu's behaviour).
    path = str(tmp_path / "ckpt.npz")
    s1 = _solver(0)
    s1.fit(niters=20, batch_size=64, progress=False)
    s1.save(path)
    s2 = _solver(1)
    s2.load(path)
    with pytest.warns(UserWarning, match="incompatible"):
        s2.fit(niters=5, batch_size=64, progress=False, optimizer="SGD")
    assert len(s2.losses) == 25


def test_auto_checkpoint_survives_midfit_crash(tmp_path):
    path = str(tmp_path / "auto.npz")
    s1 = _solver(0)

    def crash(iteration, losses):
        if iteration >= 300:
            raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError, match="simulated crash"):
        s1.fit(niters=600, batch_size=128, chunk_size=100,
               checkpoint_path=path, callback=crash, progress=False)
    # The raising callback's fit committed what completed.
    assert len(s1.losses) == 300 and s1._step_counter == 300

    # A fresh process's solver resumes from the last chunk-boundary
    # snapshot: parameters, optimizer state, losses and step counter.
    s2 = _solver(9)
    s2.load(path)
    assert len(s2.losses) == 300
    np.testing.assert_allclose(
        s2.predict(np.linspace(0, 1, 7)),
        s1.predict(np.linspace(0, 1, 7)), rtol=1e-6)
    s2.fit(niters=300, batch_size=128, progress=False)
    assert len(s2.losses) == 600
    assert s2.losses[-1] < 0.05 and s2.losses[-1] < s2.losses[0]


def test_auto_checkpoint_every_and_final(tmp_path, monkeypatch):
    # Snapshots at iterations 100 and 200 (every 100, at chunk boundaries
    # of 50) and the final one at 250, whatever the interval.
    from pydens_tpu_torch.utils import checkpoint
    path = str(tmp_path / "auto.npz")
    steps = []
    real = checkpoint.save_solver

    def spy(solver, p, **kw):
        steps.append(kw["step_counter"])
        real(solver, p, **kw)

    monkeypatch.setattr(checkpoint, "save_solver", spy)
    s1 = _solver(0)
    s1.fit(niters=250, batch_size=64, chunk_size=50, checkpoint_every=100,
           checkpoint_path=path, progress=False)
    assert steps == [100, 200, 250]
    s2 = _solver(3)
    s2.load(path)
    assert len(s2.losses) == 250
    np.testing.assert_allclose(
        s2.predict(np.linspace(0, 1, 7)),
        s1.predict(np.linspace(0, 1, 7)), rtol=1e-6)


def test_auto_checkpoint_written_on_early_callback_stop(tmp_path):
    # Early stop with checkpoint_every >> chunk: the final snapshot must
    # still land (no interval mark ever fired).
    path = str(tmp_path / "early.npz")
    s1 = _solver(0)
    s1.fit(niters=10000, batch_size=64, chunk_size=100,
           checkpoint_every=5000, checkpoint_path=path,
           callback=lambda it, losses: it >= 300, progress=False)
    assert len(s1.losses) == 300
    s2 = _solver(4)
    s2.load(path)
    assert len(s2.losses) == 300
    np.testing.assert_allclose(
        s2.predict(np.linspace(0, 1, 5)),
        s1.predict(np.linspace(0, 1, 5)), rtol=1e-6)


def test_no_final_checkpoint_after_a_nan_stop(tmp_path):
    # A non-finite stop keeps the last good snapshot (chunk 1), not the
    # diverged state.
    path = str(tmp_path / "nan.npz")
    pts = np.random.default_rng(0).uniform(size=(64, 1)).astype(np.float32)

    class Fixed:
        def sample(self, size):
            return pts[:size]

    def odevar(f, x):
        return (D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
                + V("new_var", data=np.array([1.0])))

    s = Solver(odevar, ndims=1, initial_condition=1, seed=0, device="cpu",
               constraints=lambda f, x: f(np.array([0.5])))
    s.fit(niters=2, batch_size=64, lr=0.001, sampler=Fixed(), resample=False,
          checkpoint_path=path, progress=False)
    with pytest.warns(UserWarning, match="non-finite loss"):
        s.fit(niters=30, batch_size=64, lr=30.0, sampler=Fixed(),
              resample=False, chunk_size=2, checkpoint_path=path,
              progress=False)
    stop = s.history[-1]["stopped_on_nan"]
    loaded = Solver(odevar, ndims=1, initial_condition=1, seed=1,
                    device="cpu", constraints=lambda f, x: f(np.array([0.5])))
    loaded.load(path)
    assert np.isfinite(loaded.losses).all()
    assert loaded._step_counter == 2 + 2 * ((stop - 2) // 2)


def _beam(seed):
    left = np.array([0.0], np.float32)
    return Solver(lambda f, x: D(D(D(D(f, x), x), x), x) - 384.0, ndims=1,
                  boundary_condition=0, seed=seed, activation="Tanh",
                  layout="fa fa f", features=[16, 16, 1], device="cpu",
                  constraints=lambda f, x: f.grad(left, wrt=0))


def test_auto_checkpoint_preserves_balancing_weights(tmp_path):
    # tests/test_checkpoint.py's case: a snapshot written during a balanced
    # fit holds the live term weights, which a load puts in
    # last_balanced_weights for a resumed fit's loss_terms.
    path = str(tmp_path / "bal.npz")
    s1 = _beam(0)
    assert s1.last_balanced_weights is None
    s1.fit(niters=300, batch_size=128, lr=0.01,
           loss_terms=["equation", "constraint_0"], loss_balancing=50,
           checkpoint_path=path, progress=False)
    s2 = _beam(1)
    s2.load(path)
    wts = s2.last_balanced_weights
    assert wts == s1.history[-1]["balanced_weights"] and len(wts) == 2
    assert wts[0] == 1.0 and wts[1] > 1.5   # the constraint's pushed up
    s2.fit(niters=10, batch_size=128, lr=0.01, progress=False,
           loss_terms=dict(zip(["equation", "constraint_0"], wts)))
    # A mid-fit snapshot holds the weights of its own chunk.
    s3 = _beam(0)
    s3.fit(niters=120, batch_size=128, lr=0.01, chunk_size=20,
           loss_terms=["equation", "constraint_0"], loss_balancing=5,
           checkpoint_path=path, checkpoint_every=20,
           callback=lambda it, losses: it >= 20, progress=False)
    s4 = _beam(1)
    s4.load(path)
    assert s4._step_counter == 20
    assert s4.last_balanced_weights == s3.history[-1]["balanced_weights"]


def test_save_without_balancing_stores_no_weights(tmp_path):
    path = str(tmp_path / "plain.npz")
    s1 = _solver(0)
    s1.fit(niters=5, batch_size=16, progress=False)
    s1.save(path)
    s2 = _solver(1)
    s2.last_balanced_weights = [1.0, 2.0]
    s2.load(path)
    assert s2.last_balanced_weights is None
    assert "balanced_weights" not in s2.history[-1]
