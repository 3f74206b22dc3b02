"""The model options' checks, warnings and parameter exchange against
pydens_tpu: every invalid combination of tests/test_periodic.py,
test_fourier_features.py, test_modified_mlp.py, test_laaf.py,
test_layout.py and test_wave_second_ic.py raises the same ValueError in
both packages; the periodic IC wrap probe warns where pydens_tpu warns and
the decaying binding keeps the IC exact; the new parameter leaves (``ln``,
``aa``, ``fcu``/``fcw``, ``br{i}_``) copy from pydens_tpu and go through a
checkpoint; ``n_models`` alone still raises NotImplementedError; short fits
of each option lower their loss."""

import warnings

import jax
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu.models import layout as jlayout
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.models import layout as tlayout


def _solver(pdt, equation, **kw):
    extra = dict(device="cpu") if pdt is tpdt else {}
    return pdt.Solver(equation(pdt), seed=0, **kw, **extra)


def _model(pdt, **kw):
    extra = dict(device="cpu") if pdt is tpdt else {}
    return pdt.ConvBlockModel(**kw, **extra)


def _dt(pdt):
    return lambda f, x, t: pdt.D(f, t)


def _dx(pdt):
    return lambda f, x: pdt.D(f, x)


# (match, a function making the raising call in a package)
INVALID = {
    # tests/test_periodic.py
    "periodic_not_spatial": ("spatial", lambda pdt: _solver(
        pdt, _dt, ndims=2, periodic=(1,), initial_condition=0.0)),
    "periodic_negative": ("spatial", lambda pdt: _model(
        pdt, ndims=2, periodic=(-1,), initial_condition=0.0)),
    "periodic_no_effect": ("no effect", lambda pdt: _solver(
        pdt, _dx, ndims=1, periodic=True, boundary_condition=1.0)),
    "periodic_zero_harmonics": ("harmonic", lambda pdt: _model(
        pdt, ndims=2, periodic={0: 0}, initial_condition=0.0)),
    "decay_needs_periodic": ("PERIODIC", lambda pdt: _model(
        pdt, ndims=2, initial_condition=0.0, periodic_ic_decay=True)),
    "decay_needs_ic": ("PERIODIC", lambda pdt: _model(
        pdt, ndims=2, periodic=(0,), periodic_ic_decay=True)),
    "periodic_on_base_model": ("does not support periodic", lambda pdt:
                               pdt.Model(ndims=1, periodic=(0,),
                                         **({"device": "cpu"}
                                            if pdt is tpdt else {}))),
    # tests/test_fourier_features.py
    "fourier_out_of_range": ("out of range", lambda pdt: _model(
        pdt, ndims=1, fourier_features=dict(m=4, dims=(3,)))),
    "fourier_periodic_dim": ("periodic", lambda pdt: _model(
        pdt, ndims=2, periodic=(0,), initial_condition=0.0,
        fourier_features=dict(m=4, dims=(0,)))),
    "fourier_m_zero": ("m >= 1", lambda pdt: _model(
        pdt, ndims=1, fourier_features=0)),
    # tests/test_modified_mlp.py
    "modified_widths": ("equal hidden widths", lambda pdt: _model(
        pdt, ndims=1, arch="modified", features=[8, 16, 1])),
    "modified_layout": ("drop the layout", lambda pdt: _model(
        pdt, ndims=1, arch="modified", layout="fa f", features=[8, 1])),
    "modified_branches": ("branches= only", lambda pdt: _model(
        pdt, ndims=1, arch="modified", features=[8, 1],
        branches=[dict(layout="f", features=[1])])),
    "modified_one_activation": ("one activation", lambda pdt: _model(
        pdt, ndims=1, arch="modified", features=[8, 8, 1],
        activation=["Tanh", "Sigmoid"])),
    "modified_too_short": ("at least", lambda pdt: _model(
        pdt, ndims=1, arch="modified", features=[1])),
    "unknown_arch": ("unknown arch", lambda pdt: _model(
        pdt, ndims=1, arch="resnet")),
    # tests/test_laaf.py
    "laaf_scale": ("positive scale", lambda pdt: _model(
        pdt, ndims=1, layout="fa f", features=[4, 1],
        adaptive_activation=0.0)),
    "laaf_modified": ("modified", lambda pdt: _solver(
        pdt, _dx, ndims=1, arch="modified", features=[8, 8, 1],
        adaptive_activation=5.0)),
    "laaf_no_slot": ("silent no-op", lambda pdt: _solver(
        pdt, _dx, ndims=1, layout="f f", features=[8, 1],
        adaptive_activation=5.0)),
    # tests/test_layout.py
    "unknown_token": ("unknown layout token", lambda pdt: _model(
        pdt, ndims=1, layout="fx f", features=[4, 1])),
    "unmatched_start": ("unmatched 'R'", lambda pdt: _model(
        pdt, ndims=1, layout="fB f", features=[4, 1])),
    "join_without_start": ("no matching 'R'", lambda pdt: _model(
        pdt, ndims=1, layout="fa * f", features=[4, 1])),
    "too_many_branches": ("branches= has", lambda pdt: _model(
        pdt, ndims=1, layout="fa f", features=[4, 1],
        branches=[dict(layout="f", features=[1])])),
    "branch_needs_keys": ("needs 'layout' and 'features'", lambda pdt: _model(
        pdt, ndims=1, layout="fa B f .", features=[4, 1],
        branches=[dict(features=[1])])),
    "branch_unknown_key": ("unknown branch spec key", lambda pdt: _model(
        pdt, ndims=1, layout="fa B f .", features=[4, 1],
        branches=[dict(layout="f", features=[1], nope=3)])),
    "product_width": ("product join", lambda pdt: _model(
        pdt, ndims=1, layout="fa B fa * f", features=[4, 6, 1])),
    "skip_width": ("skip connection", lambda pdt: _model(
        pdt, ndims=1, layout="faR fa + f", features=[4, 6, 1])),
    # tests/test_wave_second_ic.py
    "second_ic_needs_ic": ("requires", lambda pdt: _solver(
        pdt, _dt, ndims=2, initial_condition_t=0.0)),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_combinations_raise_in_both_packages(case):
    match, build = INVALID[case]
    for pdt in (jpdt, tpdt):
        with pytest.raises(ValueError, match=match):
            build(pdt)


def _probe_solver(pdt, **kw):
    return _solver(pdt, lambda p: lambda f, x, t: p.D(f, t) + p.D(f, x),
                   ndims=2, layout="fa f", features=[8, 1], **kw)


PROBE_CASES = {
    # tests/test_periodic.py::test_periodic_ic_decay_probe: compatible ICs
    # (a periodic sine, a constant, a soliton's decayed tail) do not warn;
    # x^2 cos(pi x) on [-1, 1] (a slope jump of 4) warns once and keeps
    # the persistent binding; the explicit choices.
    "sine": (False, False, lambda pdt: dict(
        periodic=(0,), initial_condition=lambda x: pdt.sin(2 * np.pi * x))),
    "constant": (False, False, lambda pdt: dict(
        periodic=(0,), initial_condition=1.0)),
    "soliton_tail": (False, False, lambda pdt: dict(
        periodic=(0,), domain=[(-10, 10), (0, 1)],
        initial_condition=lambda x: 2 / (0.5 * (pdt.exp(x)
                                                + pdt.exp(-x))) ** 2)),
    "kink": (True, False, lambda pdt: dict(
        periodic={0: 10}, domain=[(-1, 1), (0, 1)],
        initial_condition=lambda x: x ** 2 * pdt.cos(np.pi * x))),
    "kink_second_ic": (True, False, lambda pdt: dict(
        periodic=(0,), initial_condition=lambda x: pdt.sin(2 * np.pi * x),
        initial_condition_t=lambda x: x)),
    "opt_in": (False, True, lambda pdt: dict(
        periodic=(0,), periodic_ic_decay=True,
        initial_condition=lambda x: pdt.sin(2 * np.pi * x))),
    "silenced": (False, False, lambda pdt: dict(
        periodic=(0,), periodic_ic_decay=False,
        initial_condition=lambda x: x ** 2 * pdt.cos(np.pi * x))),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_periodic_ic_wrap_probe_warns_as_pydens_tpu(case):
    warns, engaged, opts = PROBE_CASES[case]
    for pdt in (jpdt, tpdt):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s = _probe_solver(pdt, **opts(pdt))
            assert s.model._ic_decay_engaged() == engaged
        hits = [w for w in caught
                if "incompatible with the periodic" in str(w.message)]
        assert len(hits) == (1 if warns else 0), (pdt.__name__, caught)


def test_probe_that_cannot_evaluate_the_ic_warns_and_assumes_compatible():
    # An IC with a V token cannot be probed: one warning, the persistent
    # binding (pydens_tpu/models/base.py:403-408).
    with pytest.warns(UserWarning, match="could not probe"):
        s = _probe_solver(tpdt, periodic=(0,),
                          initial_condition=lambda x: tpdt.V(
                              "amp", data=[1.0]) * x)
    assert not s.model._ic_decay_engaged()


def test_decaying_binding_keeps_the_ic_exact():
    # tests/test_periodic.py::test_periodic_ic_decay_keeps_ic_exact.
    s = _solver(tpdt, lambda p: lambda f, x, t: p.D(f, t)
                - p.D(p.D(f, x), x), ndims=2, domain=[(-1, 1), (0, 1)],
                periodic={0: 4}, periodic_ic_decay=True,
                initial_condition=lambda x: x ** 2 * tpdt.cos(np.pi * x),
                layout="fa f", features=[12, 1])
    assert s.model._ic_decay_engaged()
    xs = np.linspace(-1, 1, 64).astype(np.float32)
    got = s.predict(xs, np.zeros_like(xs)).ravel()
    np.testing.assert_allclose(got, xs ** 2 * np.cos(np.pi * xs),
                               rtol=1e-5, atol=1e-5)


def test_periodic_solution_is_periodic_by_construction():
    # tests/test_periodic.py::test_periodicity_exact_by_construction: the
    # prediction at lo and hi of a periodic dim agree to f32 rounding.
    s = _solver(tpdt, lambda p: lambda f, x, t: p.D(f, t) + p.D(f, x),
                ndims=2, periodic={0: 3}, initial_condition=0.5,
                layout="fa fa f", features=[8, 8, 1])
    ts = np.linspace(0, 1, 7).astype(np.float32)
    np.testing.assert_allclose(s.predict(np.zeros_like(ts), ts),
                               s.predict(np.ones_like(ts), ts), atol=1e-6)


KINDS = {
    "layernorm": dict(ndims=2, initial_condition=0.5, layout="fan fa f",
                      features=[6, 6, 1]),
    "laaf_branch": dict(ndims=2, initial_condition=0.5,
                        layout="fa B f .", features=[6, 1],
                        branches=[dict(layout="fa f", features=[4, 1])],
                        adaptive_activation=5.0),
    "modified": dict(ndims=2, initial_condition=0.5, arch="modified",
                     features=[6, 6, 1]),
    "fourier_periodic": dict(ndims=2, initial_condition=0.5, periodic=(0,),
                             fourier_features=3, layout="fa f",
                             features=[6, 1]),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_params_copy_from_jax_and_survive_a_checkpoint(kind, tmp_path):
    # Every leaf (ln g/b, aa a, fcu/fcw, br1_...) copies from pydens_tpu
    # with its shape, and a save/load into a fresh solver of another seed
    # restores it: the same output as pydens_tpu's on the same points.
    eq = _dt
    js = _solver(jpdt, eq, **KINDS[kind])
    ts = _solver(tpdt, eq, **KINDS[kind])
    jtree = jax.tree.map(np.asarray, js.model.params)
    ts.model.load_params(params_from_jax(jtree))
    for name, layer in jtree["net"].items():
        for leaf, value in layer.items():
            assert tuple(ts.model.params["net"][name][leaf].shape) == \
                value.shape, (name, leaf)
    pts = np.random.default_rng(2).uniform(size=(30, 2)).astype(np.float32)
    np.testing.assert_allclose(ts.predict(pts), js.predict(pts), rtol=2e-5,
                               atol=2e-5)
    path = str(tmp_path / "ckpt.npz")
    ts.save(path)
    other = tpdt.Solver(eq(tpdt), seed=5, device="cpu", **KINDS[kind])
    assert not np.allclose(other.predict(pts), ts.predict(pts))
    other.load(path)
    np.testing.assert_array_equal(other.predict(pts), ts.predict(pts))


def test_freeze_names_of_the_new_layers():
    s = _solver(tpdt, _dt, **KINDS["laaf_branch"])
    s.model.freeze_layers(["aa1", "br1_fc1", "br1_aa1"])
    mask = s.model.trainable_mask(s.model.params)
    assert mask["net"]["aa1"] == {"a": False}
    assert mask["net"]["br1_fc1"] == {"w": False, "b": False}
    assert mask["net"]["fc1"] == {"w": True, "b": True}
    with pytest.raises(AttributeError, match="unknown layer"):
        s.model.freeze_layers(["br2_fc1"])


def test_every_model_option_builds_and_n_models_trains():
    # Every model option builds, and as an ensemble (n_models=2) too, with
    # the member axis on every leaf; an ensemble trains (the member mean of
    # the loss falls over a short fit).
    for kind in KINDS.values():
        _solver(tpdt, _dt, **kind)
        ens = _solver(tpdt, _dt, n_models=2, **kind)
        assert all(t.shape[0] == 2 for t in
                   [ens.params["log_scale"]]
                   + [leaf for layer in ens.params["net"].values()
                      for leaf in layer.values()])
    s = _solver(tpdt, _dt, ndims=2, initial_condition=0.5, n_models=2)
    s.fit(niters=30, batch_size=64, lr=0.01, progress=False)
    assert np.isfinite(s.losses).all() and s.losses[-1] < s.losses[0]


FITS = {
    "periodic": dict(periodic={0: 2}, initial_condition=0.5),
    "fourier": dict(fourier_features=(4, 1.0), initial_condition=0.5),
    "second_ic": dict(initial_condition=0.5, initial_condition_t=0.0),
    **{k: v for k, v in KINDS.items() if k != "fourier_periodic"},
}


@pytest.mark.parametrize("kind", list(FITS))
def test_short_fit_lowers_the_loss(kind):
    # 60 Adam steps of a transport equation on the CPU: finite, falling.
    opts = dict(dict(ndims=2, layout="fa fa f", features=[8, 8, 1],
                     activation="Tanh"), **FITS[kind])
    if "arch" in opts:
        opts.pop("layout")
    s = _solver(tpdt, lambda p: lambda f, x, t: p.D(f, t) + p.D(f, x)
                - p.sin(np.pi * x), **opts)
    s.fit(niters=60, batch_size=64, lr=0.01, progress=False)
    losses = np.asarray(s.losses)
    assert np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()


@pytest.mark.parametrize("layout,features,branches", [
    ("fa B f . f", [6, 1, 1], [dict(layout="R f .", features=[4])]),
    ("fa B fa * f", [6, 10, 1], [dict(layout="R f .", features=[4])]),
    ("fa B f . f", [6, 1, 1], [dict(layout="R .", features=[])]),
])
def test_branch_output_width_is_its_true_width(layout, features, branches):
    # tests/test_layout.py::test_branch_output_width_is_its_true_width:
    # the width after a branch's own trailing join sizes the next layer
    # and validates a product join; a dense-free branch is a pure join.
    jinit, japply, jnames = jlayout.make_layout_network(
        layout, features, "Tanh", in_dim=2, branches=branches)
    net = tlayout.make_layout_network(layout, features, "Tanh", in_dim=2,
                                      branches=branches)
    jparams = jinit(jax.random.key(7))
    assert net.layer_names == list(jnames)
    assert {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in net.params().items()} == \
        {k: {kk: vv.shape for kk, vv in v.items()}
         for k, v in jparams.items()}
    x = np.random.default_rng(7).normal(size=(5, 2)).astype(np.float32)
    out = net.apply(params_from_jax(jax.tree.map(np.asarray, jparams)),
                    torch.from_numpy(x))
    assert net.out_dim == japply.out_dim
    np.testing.assert_allclose(out.numpy(), np.asarray(japply(jparams, x)),
                               rtol=2e-5, atol=2e-5)
