"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference works out again."""

import numpy as np
import torch

from portbench.reference import pinn

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (log_scale, outside any initial condition, has
# none at all): it is left out of the gradient and change gaps.
NEGLIGIBLE = 1e-3


def leaf_norms(config, flat):
    return np.array([float(torch.linalg.vector_norm(leaf.double()))
                     for leaf in pinn.leaves(config, flat.detach())])


def kept_leaves(config, ref_grad):
    """Indices of the leaves that count, by the reference's gradient."""
    norms = leaf_norms(config, ref_grad)
    return np.flatnonzero(norms >= NEGLIGIBLE * np.median(norms))


def norm_gap(config, prog, ref, keep):
    """The worst kept leaf's ``|norm(prog) - norm(ref)|`` over the larger of
    its reference norm and the median kept leaf's."""
    p, r = leaf_norms(config, prog)[keep], leaf_norms(config, ref)[keep]
    gap, scale = np.abs(p - r), np.maximum(r, np.median(r))
    # Where the reference did not move at all (a rejected step), any move
    # of the program's is a whole one.
    return float(np.max(np.where(scale > 0, gap / np.where(scale > 0, scale,
                                                              1.0),
                                 np.where(gap > 0, 1.0, 0.0))))


def relative_gap(prog, ref):
    """``||prog - ref|| / ||ref||``."""
    prog, ref = prog.double(), ref.double()
    return float(torch.linalg.vector_norm(prog - ref)
                 / torch.linalg.vector_norm(ref))


def loss_gap(prog, ref):
    """The worst step's relative loss gap."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(prog - ref) / np.abs(ref)))


def answer_gap(prog, ref):
    """``max |prog - ref|`` over ``max |ref|``."""
    prog = torch.as_tensor(np.asarray(prog), dtype=torch.float64)
    ref = ref.detach().to("cpu", torch.float64).reshape(prog.shape)
    return float((prog - ref).abs().max() / ref.abs().max())
