"""The yardstick's arithmetic: operations and bytes of the port's kernels
and steps, from a configuration's shapes alone (never from the program's
plan), and the card's published peaks.

Counts follow the Taylor method the kernels implement: a forward carries
the value and every derivative stream of the equation's closure through
each dense layer, ``batch x streams x sum(fan_in x fan_out)`` fused
multiply-adds; its backward does twice the forward's products and the
tangent (``J v``) three times.  Bytes count each input read once and each
output written once.
"""

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_HBM_BYTES_S = 3.35e12    # device memory
F32 = 4                       # bytes a value


def dense_shapes(config):
    fans = [config["ndims"]] + list(config["units"])
    return list(zip(fans[:-1], fans[1:]))


def products(config):
    """``sum(fan_in x fan_out)`` over the dense layers."""
    return sum(i * o for i, o in dense_shapes(config))


def net_params(config):
    """Weights and biases of the dense layers."""
    return sum(i * o + o for i, o in dense_shapes(config))


def streams(config):
    """The value and every derivative of the downward closure of the
    equation's derivatives (``u``, ``u_x``, ``u_y``, ``u_xx``, ``u_yy``
    for the Laplacian in 2D: 5)."""
    closure = {()}
    for mi in config["derivatives"]:
        mi = tuple(sorted(mi))
        closure.update(mi[:k] for k in range(1, len(mi) + 1))
    return len(closure)


def in_out(config):
    return config["ndims"], config["units"][-1]


def taylor_forward(config, n):
    """``(FMAs, bytes)`` of one Taylor forward over ``n`` points: ``x`` and
    the weights in, every stream out."""
    d_in, d_out = in_out(config)
    s = streams(config)
    fmas = n * s * products(config)
    nbytes = F32 * (n * d_in + net_params(config) + n * s * d_out)
    return fmas, nbytes


def taylor_backward(config, n):
    """Twice the forward's products; ``x``, the weights and the streams'
    cotangent in, the weights' and ``x``'s gradients out."""
    fmas, nbytes = taylor_forward(config, n)
    d_in, _ = in_out(config)
    return 2 * fmas, nbytes + F32 * (net_params(config) + n * d_in)


def taylor_jvp(config, n):
    """Three times the forward's products (the primal, tangent x W and state
    x tangent W); the weights' tangent in, the streams' tangent out."""
    fmas, nbytes = taylor_forward(config, n)
    d_in, d_out = in_out(config)
    s = streams(config)
    return 3 * fmas, nbytes + F32 * (net_params(config) + n * s * d_out)


def mlp_forward(config, n):
    """The network alone over ``n`` points: ``x`` and the weights in, the
    output out."""
    d_in, d_out = in_out(config)
    return (n * products(config),
            F32 * (n * (d_in + d_out) + net_params(config)))


def bound_s(fmas, nbytes):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(2 * fmas / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def adam_step_flops(config, n):
    """A first-order step: one Taylor forward and its backward."""
    return 2 * (taylor_forward(config, n)[0] + taylor_backward(config, n)[0])


def lm_step_flops(config, n, live_cg):
    """A Levenberg-Marquardt step: the residual and ``J^T r`` (a forward and
    a backward), a tangent and a backward in each live CG iteration, and
    the trial point's forward."""
    fwd = taylor_forward(config, n)[0]
    bwd = taylor_backward(config, n)[0]
    jvp = taylor_jvp(config, n)[0]
    return 2 * (2 * fwd + bwd + live_cg * (jvp + bwd))


def predict_flops(config, n):
    return 2 * mlp_forward(config, n)[0]
