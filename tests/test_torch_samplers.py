"""pydens_tpu_torch.samplers against pydens_tpu.samplers.

The host path is the JAX package's numpy code on the same seeded
generators, so every class's host draws must be equal bit for bit.  The
device path draws from a ``torch.Generator`` (here one on the CPU): its
draws are checked for shape, dtype, range, the first two moments (within
4 standard errors) and repeatability for the same generator seed."""

import numpy as np
import pytest
import torch

import pydens_tpu.samplers as js
import pydens_tpu_torch.samplers as ts

N = 20000   # device draws per moment check


def _circle(u):
    if torch.is_tensor(u):
        return torch.cat([torch.cos(2 * np.pi * u),
                          torch.sin(2 * np.pi * u)], dim=1)
    return np.concatenate([np.cos(2 * np.pi * u), np.sin(2 * np.pi * u)],
                          axis=1)


def _disk(p):
    return (p ** 2).sum(-1) <= 1.0


def _seeded(mixture):
    """``a | b`` takes no seed: give its component choice one."""
    mixture._rng = np.random.default_rng(31)
    return mixture


_HISTO = np.histogramdd(
    np.random.default_rng(0).normal(size=(500, 2)), bins=(4, 3))

# name -> builder(m) of one sampler from the samplers module m.
BUILDERS = {
    "uniform": lambda m: m.NS("u", dim=2, seed=1, low=-1, high=3),
    "normal": lambda m: m.NS("n", dim=2, seed=2, loc=2, scale=.5),
    "exponential": lambda m: m.NS("e", dim=2, seed=3, scale=2),
    "beta": lambda m: m.NS("b", dim=2, seed=4, a=2, b=5),
    "gamma": lambda m: m.NS("g", dim=2, seed=5, shape=3, scale=.5),
    "gamma_small": lambda m: m.NS("gamma", dim=2, seed=6, shape=.5,
                                  scale=2),
    "lognormal": lambda m: m.NS("ln", dim=2, seed=7, sigma=.5),
    "constant": lambda m: m.ConstantSampler([1.5, -2.0]),
    "scipy": lambda m: m.ScipySampler("norm", dim=2, seed=8, loc=1),
    "histo": lambda m: m.HistoSampler(_HISTO, seed=9),
    "halton": lambda m: m.HaltonSampler(dim=3, low=[0, -1, 2],
                                        high=[1, 1, 5], seed=10),
    "geometry": lambda m: m.GeometrySampler(_disk, [(-1, 1), (-1, 1)],
                                            seed=11),
    "boundary": lambda m: m.BoundarySampler(_circle, ndims=2, seed=12),
    "product": lambda m: (m.NS("u", seed=13) & m.NS("n", dim=2, seed=14)
                          & m.HaltonSampler(dim=1, base_index=2, seed=15)),
    "mixture": lambda m: m.MixtureSampler(
        [0.25 * m.NS("u", seed=16), 0.75 * m.NS("u", low=10, high=11,
                                                seed=17)], seed=18),
    "mixture_op": lambda m: _seeded(m.NS("u", seed=19)
                                    | m.NS("u", low=2, high=3, seed=20)),
    "add": lambda m: m.NS("u", seed=21) + m.NS("u", seed=22),
    "sub_scalar": lambda m: m.NS("u", seed=23) - 1.0,
    "rsub": lambda m: 1.0 - m.NS("u", seed=24),
    "div": lambda m: m.NS("u", seed=25, low=1, high=2) / 2.0,
    "times": lambda m: m.NS("u", seed=26).times(m.NS("u", seed=27)),
    "shift_scale": lambda m: m.NS("u", seed=28).shift(3.0).scale(2.0),
    "mapped": lambda m: m.NS("u", dim=2, seed=29).apply(
        lambda p: p[:, :1] * 10),
    "truncated": lambda m: m.NS("n", seed=30).truncate(-1, 1),
}
HOST_ONLY = {"scipy", "mapped", "truncated"}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_host_draws_equal_jax_bit_for_bit(name):
    a, b = BUILDERS[name](ts), BUILDERS[name](js)
    assert a.ndims == b.ndims
    assert a.supports_device == b.supports_device
    for size in (17, 5):   # two draws: the streams stay in step
        np.testing.assert_array_equal(np.asarray(a.sample(size)),
                                      np.asarray(b.sample(size)))


def test_host_only_classes_have_no_device_path():
    for name, build in BUILDERS.items():
        s = build(ts)
        assert s.supports_device == (name not in HOST_ONLY), name
        if name in HOST_ONLY:
            with pytest.raises(NotImplementedError):
                s.sample_device(torch.Generator(), 4)


def _std_uniform(lo, hi):
    return (hi - lo) / np.sqrt(12.0)


# name -> (per-column mean, per-column std, low, high) of the device draws;
# None where the bound is open.
MOMENTS = {
    "uniform": (1.0, _std_uniform(-1, 3), -1, 3),
    "normal": (2.0, .5, None, None),
    "exponential": (2.0, 2.0, 0, None),
    "beta": (2 / 7, np.sqrt(10 / (49 * 8)), 0, 1),
    "gamma": (1.5, np.sqrt(3) * .5, 0, None),
    "gamma_small": (1.0, np.sqrt(.5) * 2, 0, None),
    "lognormal": (np.exp(.125), np.sqrt((np.exp(.25) - 1) * np.exp(.25)),
                  0, None),
    "mixture": (.25 * .5 + .75 * 10.5,
                np.sqrt(.25 * (1 / 12 + .25) + .75 * (1 / 12 + 10.5 ** 2)
                        - (.25 * .5 + .75 * 10.5) ** 2), 0, 11),
    "add": (1.0, np.sqrt(2 / 12), 0, 2),
    "rsub": (.5, _std_uniform(0, 1), 0, 1),
    "times": (.25, np.sqrt(1 / 9 - 1 / 16), 0, 1),
    "shift_scale": (7.0, 2 * _std_uniform(0, 1), 6, 8),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_device_draws_have_the_distributions_moments(name):
    # Mean within 4 standard errors sigma/sqrt(N); second moment within 4
    # standard errors of its own (the sample's std of x**2 over sqrt(N)).
    mean, std, lo, hi = MOMENTS[name]
    s = BUILDERS[name](ts)
    x = s.sample_device(torch.Generator().manual_seed(0), N)
    assert x.shape == (N, s.ndims) and x.dtype == torch.float32
    x = x.double().numpy()
    if lo is not None:
        assert x.min() >= lo
    if hi is not None:
        assert x.max() <= hi
    for col in x.T:
        assert abs(col.mean() - mean) < 4 * std / np.sqrt(N)
        second = col ** 2
        assert (abs(second.mean() - (std ** 2 + mean ** 2))
                < 4 * second.std() / np.sqrt(N))


@pytest.mark.parametrize("name", sorted(set(BUILDERS) - HOST_ONLY))
def test_device_draws_repeat_for_the_same_seed(name):
    s = BUILDERS[name](ts)
    a = s.sample_device(torch.Generator().manual_seed(3), 64)
    b = s.sample_device(torch.Generator().manual_seed(3), 64)
    assert a.shape == (64, s.ndims) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_structured_device_draws():
    g = torch.Generator().manual_seed(1)
    const = BUILDERS["constant"](ts).sample_device(g, 5)
    assert torch.equal(const, torch.tensor([[1.5, -2.0]] * 5))
    disk = BUILDERS["geometry"](ts).sample_device(g, 1000)
    assert bool(_disk(disk).all())
    ring = BUILDERS["boundary"](ts).sample_device(g, 1000)
    torch.testing.assert_close(ring.norm(dim=1), torch.ones(1000))
    # Halton: every column inside its own box, and the device path
    # restarts its index at 0 on every draw (only the rotation is fresh),
    # so the pairwise spacing of index 0..n-1 repeats.
    halton = BUILDERS["halton"](ts)
    h = halton.sample_device(g, 4096)
    assert (h.min(0).values >= torch.tensor([0., -1., 2.])).all()
    assert (h.max(0).values <= torch.tensor([1., 1., 5.])).all()
    first = halton.sample_device(g, 8)[:, 0]
    again = halton.sample_device(g, 8)[:, 0]
    torch.testing.assert_close(torch.diff(first) % 1.0,
                               torch.diff(again) % 1.0)
    # Histo: every draw inside a bin of positive mass.
    histo = BUILDERS["histo"](ts)
    p = histo.sample_device(g, 2000).double().numpy()
    (counts, edges) = _HISTO
    ix = np.searchsorted(edges[0], p[:, 0], side="right") - 1
    iy = np.searchsorted(edges[1], p[:, 1], side="right") - 1
    assert (counts[np.clip(ix, 0, 3), np.clip(iy, 0, 2)] > 0).all()
    # Product: the columns of each factor, in order.
    prod = BUILDERS["product"](ts).sample_device(g, 1000)
    assert prod.shape == (1000, 4)
    assert float(prod[:, 0].min()) >= 0 and float(prod[:, 0].max()) <= 1
    assert float(prod[:, 1:3].min()) < 0


def test_geometry_device_draw_with_no_valid_candidate_is_nan():
    s = ts.GeometrySampler(lambda p: p[:, 0] > 5.0, [(0, 1)])
    assert torch.isnan(s.sample_device(torch.Generator(), 10)).all()


def test_construction_errors_match_jax():
    for m in (js, ts):
        with pytest.raises(ValueError, match="base collision"):
            m.HaltonSampler(dim=2) & m.HaltonSampler(dim=1)
        with pytest.raises(ValueError, match="share ndims"):
            m.NS("u") | m.NS("u", dim=2)
        with pytest.raises(ValueError, match="unknown distribution"):
            m.NS("cauchy")
        with pytest.raises(ValueError, match="unexpected parameters"):
            m.NS("u", loc=1)
        with pytest.raises(ValueError, match="matching ndims"):
            m.NS("u") + m.NS("u", dim=2)


def test_solver_draws_device_samplers_on_the_device():
    # A sampler with a device path draws from the Solver's generator, so
    # the same Solver seed gives the same points; a host-only one draws
    # from its own numpy generator.
    import pydens_tpu_torch as tpdt

    def pde(f, x, e):
        return tpdt.D(f, x) - e

    batches = []
    for _ in range(2):
        s = tpdt.Solver(pde, ndims=1, nparams=1, device="cpu", seed=4)
        batches.append(s._sample(BUILDERS["product"](ts).samplers[0]
                                 & ts.NS("u", low=2, high=3), 3, 10))
    assert batches[0].shape == (3, 10, 2)
    assert torch.equal(batches[0], batches[1])
    assert float(batches[0][..., 1].min()) >= 2
    host = ts.NS("u", seed=0, dim=2).truncate(0, .5)
    pts = s._sample(host, 2, 5)
    np.testing.assert_array_equal(
        pts.numpy().reshape(10, 2),
        np.float32(js.NS("u", seed=0, dim=2).truncate(0, .5).sample(10)))


def _init_uniforms(params):
    """The U(0, 1) draws behind a chain's initial weights and biases, in
    draw order: each leaf is U(-b, b) with b = 1 / sqrt(fan_in)."""
    out = []
    for name in sorted(params, key=lambda k: int(k[2:])):
        bound = 1.0 / np.sqrt(params[name]["w"].shape[0])
        for leaf in ("w", "b"):
            v = params[name][leaf].detach().numpy().ravel()
            out.append((v + bound) / (2 * bound))
    return np.concatenate(out)


def test_solver_batches_are_independent_of_the_initial_parameters():
    # pydens_tpu splits one key into independent init and sampling keys.
    # The port seeded its init generator and its sampling generator with
    # the same seed, so on the CPU the default sampler's first batches
    # were the very numbers the initial weights were drawn from (a
    # fixed-batch fit trained on them throughout).  Over 16 seeds no
    # draw may repeat, and the first batch's draws are uncorrelated with
    # the initial parameters' (|r| below 7 standard errors).
    import pydens_tpu_torch as tpdt

    us, xs = [], []
    for seed in range(16):
        s = tpdt.Solver(lambda f, x: tpdt.D(f, x), ndims=1, seed=seed,
                        device="cpu", layout="fafaf", features=[32, 32, 1],
                        activation="Tanh")
        u = _init_uniforms(s.model.params["net"])
        x = s._sample(None, 1, u.size).numpy().ravel()
        assert np.mean(np.abs(u - x) < 1e-6) < 0.01, seed
        us.append(u - u.mean())
        xs.append(x - x.mean())
    u, x = np.concatenate(us), np.concatenate(xs)
    r = float(u @ x / np.sqrt((u @ u) * (x @ x)))
    assert abs(r) < 7 / np.sqrt(u.size), r


def test_reset_restarts_the_sampling_stream_of_a_new_solver():
    # reset(seed) draws the parameters and restarts the sampling stream as
    # a new Solver(seed=seed) does.
    import pydens_tpu_torch as tpdt

    def make(seed):
        return tpdt.Solver(lambda f, x: tpdt.D(f, x), ndims=1, seed=seed,
                           device="cpu")
    s = make(3)
    s._sample(None, 2, 50)
    s.reset(seed=5)
    fresh = make(5)
    assert torch.equal(s._sample(None, 2, 50), fresh._sample(None, 2, 50))
