"""pydens_tpu_torch.models.layout against pydens_tpu.models.layout: the same
layout strings parse alike, and with the SAME parameters (copied from the
JAX init through ``params_from_jax``) the forward and the Taylor traversal
compute the same numbers.  Inputs come from seeded numpy."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydens_tpu.models import layout as jlayout
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.models import layout as tlayout

LAYOUTS = [("fa fa f", [32, 32, 1]),
           ("fa fa fa f", [10, 12, 15, 1]),
           ("faR fa fa+ f", [16, 16, 16, 1])]


def _pair(layout, features, in_dim, activation="Tanh", seed=0):
    init, apply, _ = jlayout.make_layout_network(layout, features, activation,
                                                 in_dim=in_dim)
    jparams = init(jax.random.key(seed))
    net = tlayout.make_layout_network(layout, features, activation,
                                      in_dim=in_dim)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return apply, jparams, net, tparams


@pytest.mark.parametrize("layout", ["fafaf", "fa fa f", "fa fa fa f",
                                    "faR fa fa+ f", "R f +", "cac"])
def test_parse_layout_matches(layout):
    assert tlayout.parse_layout(layout) == jlayout.parse_layout(layout)


@pytest.mark.parametrize("layout", ["fa B f .", "fa n f", "faB fa * f"])
def test_parse_layout_rejects_unported_tokens(layout):
    # The branch, join and LayerNorm tokens are ported: nothing is refused
    # any more, and they parse as in the JAX package.
    assert tlayout.parse_layout(layout) == jlayout.parse_layout(layout)


@pytest.mark.parametrize("layout,match", [
    ("fa x f", "unknown layout token"), ("fa B f", "unmatched 'R'/'B'"),
    ("fa . f", "no matching 'R'"), ("fR f", "unmatched")])
def test_parse_layout_errors_match(layout, match):
    for module in (jlayout, tlayout):
        with pytest.raises(ValueError, match=match):
            module.parse_layout(layout)


# Layouts of the superset grammar: (layout, features, branches, slopes).
SUPERSET = [
    ("fa fa B f .", [8, 8, 1], [dict(layout="fa f", features=[4, 2])],
     None),
    ("fa B fa * f", [6, 6, 1], None, None),
    ("faR fa + B f .", [6, 6, 1], None, None),
    ("fa B f . f", [6, 1, 1], [dict(layout="R f .", features=[4])], None),
    ("fa fa f", [8, 8, 1], None, 10.0),
    ("fa B fa * f", [6, 6, 1], [dict(layout="fa", features=[6],
                                     activation="Sigmoid")], 5.0),
    ("fa B B f . .", [6, 2], [dict(layout="fa B f .", features=[3, 1],
                                   branches=[dict(layout="f",
                                                  features=[2])])], 4.0),
]


def _superset_pair(layout, features, branches, slopes, seed=4):
    init, apply, names = jlayout.make_layout_network(
        layout, features, "Tanh", in_dim=3, branches=branches,
        adaptive_activation=slopes)
    jparams = init(jax.random.key(seed))
    if slopes is not None:
        # Move the slopes off 1/n so the pre-scale shows.
        jparams = {k: ({"a": v["a"] * (1.0 + 0.1 * i)} if k.startswith(
            "aa") or "_aa" in k else v) for i, (k, v) in
            enumerate(sorted(jparams.items()))}
    net = tlayout.make_layout_network(layout, features, "Tanh", in_dim=3,
                                      branches=branches,
                                      adaptive_activation=slopes)
    assert net.layer_names == list(names)
    assert net.out_dim == apply.out_dim and net.adaptive == apply.adaptive
    assert net.taylor_ok == apply.taylor_ok
    return apply, jparams, net, params_from_jax(jax.tree.map(np.asarray,
                                                             jparams))


@pytest.mark.parametrize("layout,features,branches,slopes", SUPERSET)
def test_superset_apply_and_taylor_taps_match(layout, features, branches,
                                              slopes):
    # Values rtol/atol 2e-5; taps rtol 1e-4 / atol 1e-5 (as above), order
    # 2 mixed: the product join's Leibniz rule, the branch recursion, the
    # concat of states and the slopes' pre-scale.
    apply, jparams, net, tparams = _superset_pair(layout, features,
                                                  branches, slopes)
    x = np.random.default_rng(5).normal(size=(37, 3)).astype(np.float32)
    np.testing.assert_allclose(
        net.apply(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(apply(jparams, jnp.asarray(x))), rtol=2e-5, atol=2e-5)
    closure = [(0,), (1,), (2,), (0, 0), (0, 1), (1, 2)]
    jV, jtaps = apply.taylor_taps(jparams, jnp.asarray(x), closure)
    tV, ttaps = net.taylor_taps(tparams, torch.from_numpy(x), closure)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=1e-4,
                               atol=1e-5)
    for mi in closure:
        np.testing.assert_allclose(ttaps[mi].numpy(), np.asarray(jtaps[mi]),
                                   rtol=1e-4, atol=1e-5, err_msg=str(mi))


def test_layernorm_matches_and_gates_the_plan():
    init, apply, names = jlayout.make_layout_network("fan fa f", [6, 6, 1],
                                                     "Tanh", in_dim=2)
    net = tlayout.make_layout_network("fan fa f", [6, 6, 1], "Tanh",
                                      in_dim=2)
    jparams = init(jax.random.key(2))
    jparams["ln1"] = {"g": jparams["ln1"]["g"] * 1.5,
                      "b": jparams["ln1"]["b"] + 0.25}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert net.layer_names == list(names) == ["fc1", "fc2", "fc3", "ln1"]
    x = np.random.default_rng(3).normal(size=(9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        net.apply(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(apply(jparams, jnp.asarray(x))), rtol=2e-5, atol=2e-5)
    assert not net.taylor_ok and not apply.taylor_ok
    with pytest.raises(ValueError, match="LayerNorm"):
        net.taylor_taps(tparams, torch.from_numpy(x), [(0,)])
    # Init: scale 1, bias 0.
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(net.norms["ln1"].g, torch.ones(6))
    assert torch.equal(net.norms["ln1"].b, torch.zeros(6))


def test_laaf_init_is_the_plain_network():
    # a = 1/n, so n * a = 1: the adaptive net starts as the plain one.
    plain = tlayout.make_layout_network("fa fa f", [8, 8, 1], "Tanh",
                                        in_dim=2)
    laaf = tlayout.make_layout_network("fa fa f", [8, 8, 1], "Tanh",
                                       in_dim=2, adaptive_activation=8.0)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    laaf.reset_parameters(torch.Generator().manual_seed(0))
    assert laaf.layer_names == ["fc1", "fc2", "fc3", "aa1", "aa2"]
    assert float(laaf.params()["aa1"]["a"].detach()) == pytest.approx(1 / 8)
    x = torch.rand(11, 2)
    torch.testing.assert_close(laaf(x), plain(x))


def test_modified_mlp_matches_jax():
    init, apply, names = jlayout.make_modified_mlp_network(
        [8, 8, 8, 8, 1], "Tanh", in_dim=3)
    net = tlayout.make_modified_mlp_network([8, 8, 8, 8, 1], "Tanh",
                                            in_dim=3)
    assert net.layer_names == list(names)
    jparams = init(jax.random.key(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(1).normal(size=(21, 3)).astype(np.float32)
    np.testing.assert_allclose(
        net.apply(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(apply(jparams, jnp.asarray(x))), rtol=2e-5, atol=2e-5)
    closure = [(0,), (2,), (0, 0), (0, 2)]
    jV, jtaps = apply.taylor_taps(jparams, jnp.asarray(x), closure)
    tV, ttaps = net.taylor_taps(tparams, torch.from_numpy(x), closure)
    for mi in closure:
        np.testing.assert_allclose(ttaps[mi].numpy(), np.asarray(jtaps[mi]),
                                   rtol=1e-4, atol=1e-5, err_msg=str(mi))


def test_elementwise_probe():
    # An elementwise user callable keeps the Taylor traversal; one that
    # mixes features (softmax) or changes the shape does not; the verdict
    # is cached per callable object while it lives; builtins are probed.
    def scaled_tanh(h):
        return 2.0 * torch.tanh(h)

    assert tlayout._is_elementwise(scaled_tanh)
    assert scaled_tanh in tlayout._ELEMENTWISE_CACHE
    assert tlayout._is_elementwise(torch.tanh)

    def gone(h):
        return torch.sin(h)
    assert tlayout._is_elementwise(gone)
    ref = weakref.ref(gone)
    del gone
    gc.collect()
    assert ref() is None
    assert not tlayout._is_elementwise(lambda h: torch.softmax(h, dim=-1))
    assert not tlayout._is_elementwise(lambda h: h.sum(-1))
    net = tlayout.make_layout_network("fa f", [4, 1], scaled_tanh, in_dim=2)
    assert net.taylor_ok
    net = tlayout.make_layout_network(
        "fa f", [4, 1], lambda h: torch.softmax(h, dim=-1), in_dim=2)
    assert not net.taylor_ok


@pytest.mark.parametrize("layout,features", LAYOUTS)
def test_apply_matches(layout, features):
    # Tolerance rtol/atol 2e-5, as tests/test_pallas_mlp.py: full-f32 dots
    # summed in another order.
    apply, jparams, net, tparams = _pair(layout, features, in_dim=3)
    x = np.random.default_rng(1).normal(size=(257, 3)).astype(np.float32)
    ref = np.asarray(apply(jparams, jnp.asarray(x)))
    out = net.apply(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_module_params_and_init_bounds():
    # The nn.Module path: U(+-1/sqrt(fan_in)) init, forward == apply.
    net = tlayout.make_layout_network("fa fa fa f", [10, 12, 15, 1], "Tanh",
                                      in_dim=2)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for (fan_in, _), name in zip(net.layer_shapes, net.layer_names):
        bound = 1.0 / np.sqrt(fan_in)
        for p in (net.layers[name].w, net.layers[name].b):
            assert float(p.detach().abs().max()) <= bound
    x = torch.rand(9, 2)
    torch.testing.assert_close(net(x), net.apply(net.params(), x))


@pytest.mark.parametrize("layout,features,closure", [
    # pure and mixed order-2 taps
    ("fa fa f", [16, 16, 1],
     [(0,), (1,), (2,), (0, 0), (0, 1), (1, 2), (2, 2)]),
    ("faR fa fa+ f", [16, 16, 16, 1], [(0,), (1,), (0, 0), (0, 1)]),
    # order 4 (the biharmonic mixed tap and everything below it)
    ("fa fa f", [8, 8, 1],
     [(0,), (1,), (0, 0), (0, 1), (1, 1), (0, 0, 1), (0, 1, 1),
      (0, 0, 1, 1)]),
])
def test_taylor_taps_match(layout, features, closure):
    # Tolerance rtol 1e-4 / atol 1e-5, as tests/test_layout.py's Taylor
    # traversal checks: higher taps accumulate more rounding.
    apply, jparams, net, tparams = _pair(layout, features, in_dim=3,
                                         activation="Sigmoid", seed=3)
    x = np.random.default_rng(2).normal(size=(33, 3)).astype(np.float32)
    jV, jtaps = apply.taylor_taps(jparams, jnp.asarray(x), closure)
    tV, ttaps = net.taylor_taps(tparams, torch.from_numpy(x), closure)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=1e-4,
                               atol=1e-5)
    for mi in closure:
        np.testing.assert_allclose(ttaps[mi].numpy(), np.asarray(jtaps[mi]),
                                   rtol=1e-4, atol=1e-5, err_msg=str(mi))


def test_taylor_taps_reject_open_closure():
    net = tlayout.make_layout_network("fa f", [4, 1], "Tanh", in_dim=2)
    with pytest.raises(ValueError, match="sub-multi-index"):
        net.taylor_taps(net.params(), torch.zeros(3, 2), [(0, 1)])


@pytest.mark.parametrize("name", sorted(jlayout.ACTIVATIONS))
def test_activation_table_matches_jax(name):
    # f32 elementwise functions: rtol 1e-5 / atol 1e-6.  'gelu' is the
    # trap: jax.nn.gelu defaults to the tanh approximation.
    v = np.linspace(-6.0, 6.0, 241, dtype=np.float32)
    ref = np.asarray(jlayout.ACTIVATIONS[name](jnp.asarray(v)))
    out = tlayout.ACTIVATIONS[name](torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_resolve_activation_spellings():
    assert tlayout.resolve_activation("Tanh") is torch.tanh
    assert tlayout.resolve_activation(torch.nn.Sigmoid) is torch.sigmoid
    assert tlayout.resolve_activation(torch.sin) is torch.sin
    with pytest.raises(ValueError, match="unknown activation"):
        tlayout.resolve_activation("nope")
