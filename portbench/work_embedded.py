"""Operations and bytes of the port's Taylor kernels where the chain starts
from an embedding's Taylor state, from a configuration's shapes alone: as
``portbench/work.py`` counts them, with the network's input width the
embedding's (``sin``, ``cos`` of each harmonic of a periodic column, every
other column as it is: the reference's own rule, so the count and the
check agree) and the kernels' input the state: every stream of
each embedded column, ``n x streams x width`` floats.  The backward writes
no cotangent of the state (nothing needs it: the embedding has no trained
leaf)."""

from portbench import work
from portbench.reference.periodic_pinn import dense_shapes, embed_width


def products(config):
    """``sum(fan_in x fan_out)`` over the dense layers."""
    return sum(i * o for i, o in dense_shapes(config))


def net_params(config):
    """Weights and biases of the dense layers."""
    return sum(i * o + o for i, o in dense_shapes(config))


def taylor_forward(config, n):
    """``(FMAs, bytes)`` of one Taylor forward over ``n`` points: the input
    state and the weights in, every stream out."""
    s, d_out = work.streams(config), config["units"][-1]
    fmas = n * s * products(config)
    nbytes = work.F32 * (n * s * embed_width(config) + net_params(config)
                         + n * s * d_out)
    return fmas, nbytes


def taylor_backward(config, n):
    """Twice the forward's products; the input state, the weights and the
    streams' cotangent in, the weights' gradient out."""
    fmas, nbytes = taylor_forward(config, n)
    return 2 * fmas, nbytes + work.F32 * net_params(config)


def adam_step_flops(config, n):
    """A first-order step: one Taylor forward and its backward."""
    return 2 * (taylor_forward(config, n)[0] + taylor_backward(config, n)[0])
