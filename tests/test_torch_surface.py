"""The port's public surface covers pydens_tpu's.

For ``Solver``, the model classes, ``Field``, ``Expr`` and the samplers,
every public attribute of the ``pydens_tpu`` class (and ``__init__`` and
``__call__``) must exist on the port's class, and a method's parameter
names must appear in the port's in the same order (the port may add
parameters, such as ``device``).  What a port class inherits unchanged from
``torch.nn.Module`` is left out; on a module, ``__call__`` dispatches to
``forward``, so the port's ``forward`` stands for it.  Every name of
``pydens_tpu.__all__`` must be in the port's ``__all__``.

The only exceptions are the deliberate differences in ``DELIBERATE``, and
each of them must still be a difference."""

import inspect

import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt

CLASSES = ("Solver", "Model", "ConvBlockModel", "SeparableModel",
           "TorchModel", "Field", "Expr", "Sampler", "NumpySampler",
           "ConstantSampler", "HistoSampler", "ScipySampler",
           "ProductSampler", "MixtureSampler", "GeometrySampler",
           "BoundarySampler", "HaltonSampler")
MODELS = ("Model", "ConvBlockModel", "SeparableModel", "TorchModel")
SAMPLERS = tuple(name for name in CLASSES if name.endswith("Sampler"))

# name -> (the (class or "__all__", attribute) pairs it covers, the reason)
DELIBERATE = {
    "module_model": (
        {("__all__", "FlaxModel"), ("__all__", "flax_model")},
        "the adapter wraps a torch.nn.Module, not a flax module: "
        "ModuleModel / module_model"),
    "sample_device": (
        {(name, "sample_device") for name in SAMPLERS},
        "a device draw takes a torch.Generator, not a jax.random key"),
    "jax_only": (
        {(name, attr) for name in MODELS
         for attr in ("network_init", "init_params", "network_apply_fused")},
        "JAX-only: a pytree drawn from a PRNG key, and the Pallas-fused "
        "apply; a port model owns its parameters and routes to its kernel "
        "itself"),
}


def _params(fn):
    names = list(inspect.signature(fn).parameters)
    return tuple(names[1:] if names[:1] in (["self"], ["cls"]) else names)


def _surface(cls):
    """Public name -> parameter names (a method) or ``None`` (a property
    or any other attribute)."""
    module = issubclass(cls, torch.nn.Module)
    absent = object()
    out = {}
    for name in dir(cls):
        if name.startswith("_") and name not in ("__init__", "__call__"):
            continue
        value = inspect.getattr_static(cls, name)
        if module and value is inspect.getattr_static(torch.nn.Module, name,
                                                      absent):
            continue
        if isinstance(value, (staticmethod, classmethod)):
            value = value.__func__
        out[name] = _params(value) if inspect.isfunction(value) else None
    if module and "forward" in out:
        out["__call__"] = out["forward"]
    return out


def _in_order(sub, full):
    it = iter(full)
    return all(name in it for name in sub)


def _differences(name):
    jax_side = _surface(getattr(jpdt, name))
    port = _surface(getattr(tpdt, name))
    found = set()
    for attr, params in jax_side.items():
        if attr not in port:
            found.add((name, attr))
        elif params is not None and (port[attr] is None
                                     or not _in_order(params, port[attr])):
            found.add((name, attr))
    return found


def _allowed():
    return set().union(*(pairs for pairs, _ in DELIBERATE.values()))


@pytest.mark.parametrize("name", CLASSES)
def test_class_surface_covers_pydens_tpu(name):
    extra = _differences(name) - _allowed()
    assert not extra, sorted(extra)


def test_all_covers_pydens_tpu():
    missing = {("__all__", n) for n in jpdt.__all__} - {
        ("__all__", n) for n in tpdt.__all__}
    assert not missing - _allowed(), sorted(missing - _allowed())


def test_deliberate_differences_are_exactly_these():
    found = set().union(*(_differences(name) for name in CLASSES))
    found |= {("__all__", n) for n in set(jpdt.__all__) - set(tpdt.__all__)}
    assert found == _allowed(), (sorted(found - _allowed()),
                                 sorted(_allowed() - found))
    assert all(reason for _, reason in DELIBERATE.values())


def test_the_port_names_the_renamed_adapter():
    assert {"ModuleModel", "module_model"} <= set(tpdt.__all__)
    assert _params(tpdt.Sampler.sample_device) == ("generator", "size")
    assert _params(jpdt.Sampler.sample_device) == ("key", "size")
