"""Fused Taylor traversal of a dense chain — forward and backward kernels
for Hopper, with their plain PyTorch versions.

Counterpart of ``pydens_tpu/ops/pallas_taylor.py`` (``make_fused_taylor``).
For a dense ``f``/``c``/``a`` chain and an order-<=2 derivative plan it
computes, per point, the value stream V, the first-order streams T_d and
the second-order streams S_ab, stacked as ``(n, n_streams * out_dim)``
columns ``[V, T..., S...]`` — everything ``Model.full_taps`` needs for a
Poisson-type residual in one traversal.

* :func:`fused_taylor_forward` / :func:`fused_taylor_backward` launch the
  CUDA kernels of ``csrc/fused_taylor.cu`` for CUDA tensors (and raise if
  they cannot) and take the plain versions only for CPU tensors.  Each
  keeps a ``launches`` counter of kernel launches.
* :func:`fused_taylor_forward_plain` is the same traversal in torch ops;
  :func:`fused_taylor_backward_plain` is its autograd VJP.
* :class:`FusedTaylor` binds the two into one ``torch.autograd.Function``.

The chain reaches the kernels as an int32 op table plus ONE packed weight
buffer (each layer's ``w`` row-major, then its ``b``), so one compiled
kernel serves every chain in scope.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..models.layout import ACTIVATIONS
from ._build import (MAX_SHARED_BYTES, check_operand, launch_checked,
                     load_library)

__all__ = ["supports", "TaylorPlan", "FusedTaylor", "fused_taylor_taps",
           "fused_taylor_forward", "fused_taylor_forward_plain",
           "fused_taylor_backward", "fused_taylor_backward_plain",
           "pack_weights", "split_streams", "act_kind", "sigma_table"]

TANH, SIGMOID, SIN = 0, 1, 2
_ACT_KINDS = {id(ACTIVATIONS["tanh"]): TANH,
              id(ACTIVATIONS["sigmoid"]): SIGMOID,
              id(ACTIVATIONS["sin"]): SIN}

# csrc/fused_taylor.cu: TILE_POINTS, ROW_PAD, MIN_BLOCKS_PER_SM.
_TILE_POINTS = 16
_ROW_PAD = 4
_BLOCKS_PER_SM = 2
# Shared memory of one H100 SM, and what CUDA reserves of it per block.
_SM_SHARED_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024
_SM_COUNTS = {}


def act_kind(act):
    """The kernels' code for an activation callable, or None."""
    return _ACT_KINDS.get(id(act))


def sigma_table(kind, v):
    """``[σ, σ', σ'', σ''']`` at ``v`` in closed form — a Python mirror of
    the device code's ``sigma_derivs``."""
    if kind == TANH:
        t = torch.tanh(v)
        d1 = 1.0 - t * t
        return [t, d1, -2.0 * t * d1, -2.0 * d1 * (d1 - 2.0 * t * t)]
    if kind == SIGMOID:
        s = torch.sigmoid(v)
        d1 = s * (1.0 - s)
        u = 1.0 - 2.0 * s
        return [s, d1, d1 * u, d1 * (u * u - 2.0 * d1)]
    if kind == SIN:
        s, c = torch.sin(v), torch.cos(v)
        return [s, c, -s, -c]
    raise ValueError(f"no closed-form derivatives for activation kind {kind}")


def pack_weights(net_params, layer_names):
    """One flat buffer: each layer's ``w`` (row-major), then its ``b``."""
    return torch.cat([t.reshape(-1) for name in layer_names
                      for t in (net_params[name]["w"], net_params[name]["b"])])


def _taylor_smem_bytes(n_params, n_streams, wmax, n_bufs):
    """Shared memory of one block: the packed weights (rounded up to 16
    bytes) and ``n_bufs`` tile states of ``wmax`` features x
    ``n_streams * TILE_POINTS`` rows (2 in the forward, 3 in the
    backward) — ``taylor_smem_bytes`` of the CUDA source."""
    ld = n_streams * _TILE_POINTS + _ROW_PAD
    return 4 * (-(-n_params // 4) * 4 + n_bufs * wmax * ld)


def _chain_ops(tokens, acts, layer_shapes):
    """(kind, ...) records of an f/c/a chain with packed-weight offsets."""
    ops, off, di, ai = [], 0, 0, 0
    for tok in tokens:
        if tok in ("f", "c"):
            K, N = layer_shapes[di]
            ops.append(("dense", K, N, off, off + K * N))
            off += K * N + N
            di += 1
        else:
            ops.append(("act", act_kind(acts[ai])))
            ai += 1
    return ops, off


def supports(tokens, acts, closure, layer_shapes, in_dim,
             dtype=torch.float32):
    """Whether the fused kernels cover this (layout, plan): a dense chain
    (no skips), activations with closed-form derivatives (tanh, sigmoid,
    sin), derivative multi-indices of order <= 2, float32, and a state
    that fits one block's shared memory."""
    if dtype != torch.float32 or not closure:
        return False
    if any(t not in ("f", "c", "a") for t in tokens):
        return False
    if any(act_kind(a) is None for a in acts):
        return False
    if any(len(mi) > 2 for mi in closure):
        return False
    n_streams = 1 + len(closure)
    wmax = max([in_dim] + [n for _, n in layer_shapes])
    n_params = sum(k * n + n for k, n in layer_shapes)
    return _taylor_smem_bytes(n_params, n_streams, wmax, 3) <= MAX_SHARED_BYTES


class TaylorPlan:
    """The op table and sizes of one (chain, closure) for the kernels."""

    def __init__(self, tokens, acts, closure, layer_shapes, in_dim):
        closure = [tuple(mi) for mi in closure]
        if not supports(tokens, acts, closure, layer_shapes, in_dim):
            raise ValueError("fused Taylor kernel: unsupported layout/plan")
        self.firsts = [mi[0] for mi in closure if len(mi) == 1]
        self.pairs = [mi for mi in closure if len(mi) == 2]
        pos = {d: i for i, d in enumerate(self.firsts)}
        self.in_dim = in_dim
        self.n_streams = 1 + len(self.firsts) + len(self.pairs)
        self.ops, self.n_params = _chain_ops(tokens, acts, layer_shapes)
        self.out_dim = layer_shapes[-1][1]
        self.wmax = max([in_dim] + [n for _, n in layer_shapes])
        # What the backward keeps per point of a tile: the input state of
        # every activation, and of a dense layer fed by another dense
        # layer.  Every other dense input is x or an activation applied
        # again to its saved input.  save_offsets[i] is op i's first row in
        # the slab (S * width rows each), or -1.
        records, self.save_offsets = [], []
        width, save, prev = in_dim, 0, None
        for op in self.ops:
            keep = op[0] == "act" or prev == "dense"
            self.save_offsets.append(save if keep else -1)
            off = self.save_offsets[-1]
            if op[0] == "dense":
                records += [0, op[1], op[2], op[3], op[4], off]
            else:
                records += [1, width, op[1], 0, 0, off]
            if keep:
                save += self.n_streams * width
            if op[0] == "dense":
                width = op[2]
            prev = op[0]
        self.save_rows = save
        table = [len(self.ops), in_dim, len(self.firsts), len(self.pairs),
                 self.wmax, self.save_rows, *self.firsts]
        for a, b in self.pairs:
            table += [pos[a], pos[b]]
        self.table = table + records
        self._device_tables = {}

    def smem_bytes(self, n_bufs):
        return _taylor_smem_bytes(self.n_params, self.n_streams, self.wmax,
                                  n_bufs)

    def launch_shape(self, n, sm_count, n_bufs):
        """``(grid, slots)`` of a launch over ``n`` points: ``slots``
        persistent blocks fit the card at once (``MIN_BLOCKS_PER_SM`` per
        SM where shared memory allows, else one), and the grid is the
        smaller of that and the number of tiles."""
        per_block = self.smem_bytes(n_bufs) + _BLOCK_RESERVED_BYTES
        per_sm = (_BLOCKS_PER_SM
                  if _BLOCKS_PER_SM * per_block <= _SM_SHARED_BYTES else 1)
        slots = sm_count * per_sm
        return min(-(-n // _TILE_POINTS), slots), slots

    def backward_workspace(self, n, sm_count):
        """``(grid, save_floats, partial_floats)`` of one backward launch.
        The workspace is sized by the slots, never by ``n``: a per-block
        slab of ``save_rows * TILE_POINTS`` floats and a per-block partial
        gradient of ``n_params`` floats."""
        grid, slots = self.launch_shape(n, sm_count, 3)
        return (grid, slots * self.save_rows * _TILE_POINTS,
                slots * self.n_params)

    def device_table(self, device):
        if device not in self._device_tables:
            self._device_tables[device] = torch.tensor(
                self.table, dtype=torch.int32, device=device)
        return self._device_tables[device]


def _lib():
    lib = load_library()
    if lib.pdt_taylor_tile_points() != _TILE_POINTS:
        raise RuntimeError("csrc/fused_taylor.cu and fused_taylor.py "
                           "disagree on the points per tile")
    return lib


def _sm_count(device):
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


def _check_kernel_args(packed, x, plan):
    n = x.shape[0]
    check_operand("x", x, (n, plan.in_dim))
    check_operand("packed", packed, (plan.n_params,))
    if packed.device != x.device:
        raise ValueError(f"packed weights on {packed.device}, points on "
                         f"{x.device}")
    return n


def fused_taylor_forward(packed, x, plan):
    """Streams ``[V, T..., S...]`` of the chain at points ``x`` as
    ``(n, n_streams * out_dim)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_taylor_forward_plain(packed, x, plan)
    n = _check_kernel_args(packed, x, plan)
    out = torch.empty((n, plan.n_streams * plan.out_dim), dtype=x.dtype,
                      device=x.device)
    if n == 0:
        return out
    lib = _lib()
    grid, _ = plan.launch_shape(n, _sm_count(x.device), 2)
    err = lib.pdt_taylor_forward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        out.data_ptr(), n, plan.n_params, plan.n_streams, plan.wmax,
        plan.out_dim, grid, torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_taylor_forward", err)
    fused_taylor_forward.launches += 1
    return out


fused_taylor_forward.launches = 0


def fused_taylor_forward_plain(packed, x, plan):
    """The traversal of :func:`fused_taylor_forward` in torch ops, with the
    closed-form activation derivatives of :func:`sigma_table`."""
    n = x.shape[0]
    eye = torch.eye(plan.in_dim, dtype=x.dtype, device=x.device)
    V = x
    T = [eye[d].expand(n, plan.in_dim) for d in plan.firsts]
    S = [x.new_zeros((n, plan.in_dim)) for _ in plan.pairs]
    pos = {d: i for i, d in enumerate(plan.firsts)}
    for op in plan.ops:
        if op[0] == "dense":
            _, K, N, w_off, b_off = op
            w = packed[w_off:w_off + K * N].view(K, N)
            out = torch.stack([V] + T + S) @ w
            V = out[0] + packed[b_off:b_off + N]
            T = list(out[1:1 + len(T)])
            S = list(out[1 + len(T):])
        else:
            d = sigma_table(op[1], V)
            S = [d[2] * T[pos[a]] * T[pos[b]] + d[1] * s
                 for (a, b), s in zip(plan.pairs, S)]
            T = [d[1] * t for t in T]
            V = d[0]
    return torch.cat([V] + T + S, dim=1)


def fused_taylor_backward(packed, x, g, plan):
    """``(d packed, d x)`` for the cotangent ``g`` of
    :func:`fused_taylor_forward`'s output: the CUDA kernels (persistent
    blocks, each summing its tiles into one partial, then a fixed-order sum
    over blocks) for CUDA tensors, the plain version for CPU tensors.  The
    workspace does not grow with ``n``
    (:meth:`TaylorPlan.backward_workspace`)."""
    if x.device.type == "cpu":
        return fused_taylor_backward_plain(packed, x, g, plan)
    n = _check_kernel_args(packed, x, plan)
    check_operand("g", g, (n, plan.n_streams * plan.out_dim))
    d_packed = torch.empty((plan.n_params,), dtype=x.dtype, device=x.device)
    dx = torch.empty((n, plan.in_dim), dtype=x.dtype, device=x.device)
    if n == 0:
        return d_packed.zero_(), dx
    grid, save_floats, partial_floats = plan.backward_workspace(
        n, _sm_count(x.device))
    saves = torch.empty((save_floats,), dtype=x.dtype, device=x.device)
    partials = torch.empty((partial_floats,), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.pdt_taylor_backward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        g.data_ptr(), saves.data_ptr(), partials.data_ptr(),
        d_packed.data_ptr(), dx.data_ptr(), n, plan.n_params, plan.n_streams,
        plan.wmax, plan.out_dim, grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_taylor_backward", err)
    fused_taylor_backward.launches += 1
    return d_packed, dx


fused_taylor_backward.launches = 0


def fused_taylor_backward_plain(packed, x, g, plan):
    """The VJP of :func:`fused_taylor_forward_plain` by autograd."""
    with torch.enable_grad():
        p = packed.detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        out = fused_taylor_forward_plain(p, xx, plan)
        d_packed, dx = torch.autograd.grad(out, (p, xx), g)
    return d_packed, dx


class FusedTaylor(torch.autograd.Function):
    """The fused traversal as a differentiable op: forward and backward
    each run :func:`fused_taylor_forward` / :func:`fused_taylor_backward`."""

    @staticmethod
    def forward(ctx, packed, x, plan):
        ctx.save_for_backward(packed, x)
        ctx.plan = plan
        return fused_taylor_forward(packed, x, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        packed, x = ctx.saved_tensors
        d_packed, dx = fused_taylor_backward(packed, x, g.contiguous(),
                                             ctx.plan)
        return d_packed, (dx if ctx.needs_input_grad[1] else None), None


def split_streams(out, plan):
    """``(V, {(d,): T_d, (a, b): S_ab})`` from the stacked stream columns."""
    k = plan.out_dim
    taps = {}
    for i, d in enumerate(plan.firsts):
        taps[(d,)] = out[:, (1 + i) * k:(2 + i) * k]
    for j, pair in enumerate(plan.pairs):
        s = 1 + len(plan.firsts) + j
        taps[tuple(pair)] = out[:, s * k:(s + 1) * k]
    return out[:, :k], taps


def fused_taylor_taps(packed, x, plan):
    """``(V, taps)`` of the chain through :class:`FusedTaylor`."""
    return split_streams(FusedTaylor.apply(packed, x.contiguous(), plan),
                         plan)
