"""What the benchmark makes from ``--seed`` and hands to the program and the
reference alike: initial weights, the seeds of the solver's sampling
generator and predict grids.

Every stream is seeded from the run's seed and a fixed tag, so the same
seed gives the same inputs, and the weights are drawn on the device in one
call, in float32, the dtype they are served in.
"""

import numpy as np
import torch

from portbench.reference import pinn

# Stream tags: one per kind of input, so that the streams never overlap.
WEIGHTS, POINTS, CHECK_WEIGHTS, CHECK_POINTS, GRIDS, SAMPLE = range(6)


def substream(seed, tag, index=0):
    """A 63-bit seed of stream ``tag`` (and ``index``) of the run."""
    words = np.random.SeedSequence([int(seed), tag, index]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def weights(config, seed, tag, count, device):
    """``(count, P)`` flat initial parameters in the reference's leaf order:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every dense leaf, 0 for
    ``log_scale``, drawn on the device in one call."""
    bounds = pinn.init_bounds(config, device)
    gen = torch.Generator(device=device).manual_seed(substream(seed, tag))
    draw = torch.rand((count, bounds.numel()), generator=gen, device=device,
                      dtype=torch.float32)
    return (2 * draw - 1) * bounds


def tree(config, theta):
    """``theta`` as the nested parameter tree ``Model.load_params`` takes."""
    out = {"net": {}, "variables": {}}
    for path, leaf in pinn.unflatten(config, theta).items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def grids(seed, count, side, ndims):
    """``count`` host lattices of ``side ** ndims`` points in [0, 1)^ndims,
    stacked ``(points, ndims)`` float32, each shifted by its own offset
    below one cell, so that no two are alike."""
    rng = np.random.default_rng(substream(seed, GRIDS))
    out = []
    for _ in range(count):
        axes = [(np.arange(side) + rng.random()) / side
                for _ in range(ndims)]
        mesh = np.meshgrid(*axes, indexing="ij")
        out.append(np.stack([m.reshape(-1) for m in mesh], -1)
                   .astype(np.float32))
    return out
