"""pydens_tpu_torch.models.layout against pydens_tpu.models.layout: the same
layout strings parse alike, and with the SAME parameters (copied from the
JAX init through ``params_from_jax``) the forward and the Taylor traversal
compute the same numbers.  Inputs come from seeded numpy."""

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
    jlayout.parse_layout(layout)  # valid in the JAX package
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tlayout.parse_layout(layout)


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
