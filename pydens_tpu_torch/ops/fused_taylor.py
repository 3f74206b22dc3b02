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
  keeps a ``launches`` counter of its wrapper calls; a CUDA-graph replay
  makes none.
* :func:`fused_taylor_forward_plain` is the same traversal in torch ops;
  :func:`fused_taylor_backward_plain` is its autograd VJP.
* :func:`fused_taylor_jvp` launches the tangent kernel (the traversal and
  its tangent with respect to the packed weights) for CUDA tensors;
  :func:`fused_taylor_jvp_plain` is ``torch.func.jvp`` of the plain forward.
* :class:`FusedTaylor` binds them into one ``torch.autograd.Function``
  whose backward is differentiable once more with respect to its cotangent:
  the VJP of ``g -> J^T g`` is ``J v``, the tangent kernel.  That is how a
  Levenberg-Marquardt step takes ``J v`` of the residual through the plan.

The chain reaches the kernels as an int32 op table plus ONE packed weight
buffer (each layer's ``w`` row-major, then its ``b``), so one compiled
kernel serves every chain in scope.  An ensemble's packed weights are
``(K, P)``, one row a member, and every stream output gains a leading
``K``; the points stay shared, ``(n, in_dim)``, and one launch serves all
members (the grid's second axis).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..models.layout import ACTIVATIONS
from ._build import (MAX_SHARED_BYTES, check_operand, check_packed,
                     launch_checked, load_library)

__all__ = ["supports", "TaylorPlan", "FusedTaylor", "fused_taylor_taps",
           "fused_taylor_forward", "fused_taylor_forward_plain",
           "fused_taylor_backward", "fused_taylor_backward_plain",
           "fused_taylor_jvp", "fused_taylor_jvp_plain", "jvp_blocks_per_sm",
           "pack_weights", "members", "split_streams", "act_kind",
           "sigma_table"]

TANH, SIGMOID, SIN = 0, 1, 2
_ACT_KINDS = {id(ACTIVATIONS["tanh"]): TANH,
              id(ACTIVATIONS["sigmoid"]): SIGMOID,
              id(ACTIVATIONS["sin"]): SIN}

# csrc/fused_taylor.cu: TILE_POINTS, ROW_PAD, MIN_BLOCKS_PER_SM, and the
# tangent kernel's THREADS, RING_SLOTS, RING_ROWS and SPLIT_FLOATS.
_TILE_POINTS = 16
_ROW_PAD = 4
_BLOCKS_PER_SM = 2
_THREADS = 256
_RING_SLOTS = 3
_RING_ROWS = 8
_SPLIT_FLOATS = 2 * 4 * _THREADS
# The tangent kernel's points per tile, the largest first.
_JVP_TILES = (16, 8, 4)
# W and its tangent, together, at most this many floats (32 KB): the
# tangent kernel keeps them resident instead of streaming them.
_JVP_RESIDENT_FLOATS = 8192
# Shared memory of one H100 SM, and what CUDA reserves of it per block.
_SM_SHARED_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024
_SM_COUNTS = {}
_JVP_BLOCKS_PER_SM = {}


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
    """One flat buffer: each layer's ``w`` (row-major), then its ``b``; an
    ensemble's (leaves with a leading member axis) one row a member,
    ``(K, P)``."""
    lead = tuple(net_params[layer_names[0]]["w"].shape[:-2])
    return torch.cat([t.reshape(lead + (-1,)) for name in layer_names
                      for t in (net_params[name]["w"], net_params[name]["b"])],
                     dim=-1)


def members(packed):
    """The ensemble members of packed weights: ``K`` for ``(K, P)``, 1 for
    a single model's ``(P,)``."""
    return 1 if packed.dim() == 1 else packed.shape[0]


def _per_member(grid_slots, tiles, n_members):
    """Persistent blocks a member: the card's ``slots`` shared by the
    members (at least one each), at most one a tile."""
    return min(tiles, max(1, grid_slots // n_members))


def _taylor_smem_bytes(n_params, n_streams, wmax, n_bufs):
    """Shared memory of one forward or backward block: the packed weights
    (rounded up to 16 bytes) and ``n_bufs`` tile states of ``wmax``
    features x ``n_streams * TILE_POINTS`` rows (the forward 2, the
    backward 3) — ``taylor_smem_bytes`` of the CUDA source."""
    ld = n_streams * _TILE_POINTS + _ROW_PAD
    return 4 * (_weights_floats(n_params) + n_bufs * wmax * ld)


def _weights_floats(n_params):
    return -(-n_params // 4) * 4


def _jvp_smem_bytes(n_streams, wmax, tile, n_params, resident):
    """Shared memory of one tangent-kernel block at ``tile`` points a tile:
    four tile states and the ring of weight slices (``RING_SLOTS`` slots of
    ``RING_ROWS * wmax`` floats of W and of its tangent, each with room for
    a 16-byte alignment shift), or the split-K partials it holds where they
    are larger; with ``resident``, W and its tangent whole and the split-K
    partials — ``taylor_jvp_smem_bytes`` of the CUDA source."""
    ld = n_streams * tile + _ROW_PAD
    if resident:
        region = 2 * _weights_floats(n_params) + _SPLIT_FLOATS
    else:
        slot = -(-_RING_ROWS * wmax // 4) * 4 + 4
        region = max(_RING_SLOTS * 2 * slot, _SPLIT_FLOATS)
    return 4 * (4 * wmax * ld + region)


def _jvp_tile(n_streams, wmax, n_params, resident):
    """The tangent kernel's points per tile: the largest of ``_JVP_TILES``
    whose block fits shared memory.  The smallest fits wherever the
    backward's block does (tests/test_torch_fused_kernels.py sweeps it)."""
    for tile in _JVP_TILES[:-1]:
        if _jvp_smem_bytes(n_streams, wmax, tile, n_params,
                           resident) <= MAX_SHARED_BYTES:
            return tile
    return _JVP_TILES[-1]


def _jvp_mode(n_streams, wmax, n_params):
    """``(resident, tile)`` of the tangent kernel: W and its tangent kept
    whole in shared memory where together they take at most
    ``_JVP_RESIDENT_FLOATS`` and the block then holds as many points a
    tile and blocks per SM as with the weights streamed; else streamed
    through the ring."""
    tile = _jvp_tile(n_streams, wmax, n_params, False)
    per_sm = _blocks_per_sm(_jvp_smem_bytes(n_streams, wmax, tile, n_params,
                                            False))
    if 2 * _weights_floats(n_params) <= _JVP_RESIDENT_FLOATS:
        res_tile = _jvp_tile(n_streams, wmax, n_params, True)
        res_smem = _jvp_smem_bytes(n_streams, wmax, res_tile, n_params, True)
        if (res_tile >= tile and res_smem <= MAX_SHARED_BYTES
                and _blocks_per_sm(res_smem) >= per_sm):
            return True, res_tile
    return False, tile


def _blocks_per_sm(smem):
    """``MIN_BLOCKS_PER_SM`` where that many blocks of ``smem`` bytes fit an
    SM's shared memory, else one: the forward's and backward's blocks per
    SM, and what the tangent kernel's block is sized for."""
    per_block = smem + _BLOCK_RESERVED_BYTES
    return (_BLOCKS_PER_SM if _BLOCKS_PER_SM * per_block <= _SM_SHARED_BYTES
            else 1)


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
             dtype=torch.float32, adaptive=False):
    """Whether the fused kernels cover this (layout, plan): a dense chain
    (no skips, branches, joins or LayerNorm), activations with closed-form
    derivatives (tanh, sigmoid, sin) and no adaptive-activation slopes,
    derivative multi-indices of order <= 2, float32, and a state that fits
    one block's shared memory.  The tangent kernel takes every such chain
    (:func:`_jvp_tile`)."""
    if dtype != torch.float32 or not closure or adaptive:
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
        # The tangent kernel: its weights resident or streamed, its points
        # per tile, shared memory, and the blocks per SM that shared memory
        # allows (the card's count, registers included, is
        # :func:`jvp_blocks_per_sm`).
        self.jvp_resident, self.jvp_tile = _jvp_mode(
            self.n_streams, self.wmax, self.n_params)
        self.jvp_smem = _jvp_smem_bytes(self.n_streams, self.wmax,
                                        self.jvp_tile, self.n_params,
                                        self.jvp_resident)
        self.jvp_blocks_per_sm = _blocks_per_sm(self.jvp_smem)
        self._device_tables = {}

    def smem_bytes(self, n_bufs):
        return _taylor_smem_bytes(self.n_params, self.n_streams, self.wmax,
                                  n_bufs)

    def launch_shape(self, n, sm_count, n_bufs, n_members=1):
        """``(grid, slots)`` of a forward (``n_bufs`` 2) or backward (3)
        launch over ``n`` points: ``slots`` persistent blocks fit the card
        at once (``MIN_BLOCKS_PER_SM`` per SM where shared memory allows,
        else one), and ``grid``, the blocks of each of ``n_members``
        ensemble members (the grid's second axis), is the smaller of
        ``max(1, slots // n_members)`` and the number of tiles."""
        slots = sm_count * _blocks_per_sm(self.smem_bytes(n_bufs))
        return _per_member(slots, -(-n // _TILE_POINTS), n_members), slots

    def jvp_kernel_args(self):
        """The sizes the tangent kernel's C entries take:
        ``(n_streams, wmax, tile, n_params, resident)``."""
        return (self.n_streams, self.wmax, self.jvp_tile, self.n_params,
                int(self.jvp_resident))

    def jvp_launch_shape(self, n, sm_count, blocks_per_sm, n_members=1):
        """``(grid, slots)`` of a tangent-kernel launch of ``blocks_per_sm``
        blocks on each of ``sm_count`` SMs: as :meth:`launch_shape` with its
        own block and tile."""
        slots = sm_count * blocks_per_sm
        return _per_member(slots, -(-n // self.jvp_tile), n_members), slots

    def backward_workspace(self, n, sm_count, n_members=1):
        """``(grid, save_floats, partial_floats)`` of one backward launch.
        The workspace is sized by the slots, never by ``n``: a slab of
        ``save_rows * TILE_POINTS`` floats and a partial gradient of
        ``n_params`` floats for each of the ``max(1, slots // n_members)``
        blocks of each member."""
        grid, slots = self.launch_shape(n, sm_count, 3, n_members)
        blocks = n_members * max(1, slots // n_members)
        return (grid, blocks * self.save_rows * _TILE_POINTS,
                blocks * self.n_params)

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


def jvp_blocks_per_sm(plan, device):
    """Blocks of the plan's tangent kernel that one SM of ``device`` holds
    at once: the CUDA occupancy calculator (registers and shared memory),
    cached per device and sizes."""
    key = (device, plan.jvp_kernel_args())
    if key not in _JVP_BLOCKS_PER_SM:
        blocks = _lib().pdt_taylor_jvp_blocks_per_sm(*plan.jvp_kernel_args())
        if blocks <= 0:
            raise RuntimeError("pdt_taylor_jvp_blocks_per_sm: no block of the "
                               f"tangent kernel fits an SM (code {blocks})")
        _JVP_BLOCKS_PER_SM[key] = blocks
    return _JVP_BLOCKS_PER_SM[key]


def _sm_count(device):
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


def _stream_shape(packed, n, plan):
    return tuple(packed.shape[:-1]) + (n, plan.n_streams * plan.out_dim)


def fused_taylor_forward(packed, x, plan):
    """Streams ``[V, T..., S...]`` of the chain at points ``x`` as
    ``(n, n_streams * out_dim)``, or ``(K, n, ...)`` for an ensemble's
    ``(K, P)`` weights: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return fused_taylor_forward_plain(packed, x, plan)
    n = check_packed(packed, x, plan)
    out = torch.empty(_stream_shape(packed, n, plan), dtype=x.dtype,
                      device=x.device)
    if n == 0:
        return out
    lib = _lib()
    K = members(packed)
    grid, _ = plan.launch_shape(n, _sm_count(x.device), 2, K)
    err = lib.pdt_taylor_forward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        out.data_ptr(), n, plan.n_params, plan.n_streams, plan.wmax,
        plan.out_dim, grid, K, torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_taylor_forward", err)
    fused_taylor_forward.launches += 1
    return out


# Wrapper calls; a CUDA-graph replay makes none.
fused_taylor_forward.launches = 0


def fused_taylor_forward_plain(packed, x, plan):
    """The traversal of :func:`fused_taylor_forward` in torch ops, with the
    closed-form activation derivatives of :func:`sigma_table`; an
    ensemble's, member by member."""
    if packed.dim() == 2:
        return torch.stack([fused_taylor_forward_plain(p, x, plan)
                            for p in packed.unbind(0)])
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
            # Indexed rows, not list(): unbinding an empty slice does not
            # survive torch.export's serialization.
            S = [out[1 + len(T) + j] for j in range(len(S))]
            T = [out[1 + i] for i in range(len(T))]
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
    over a member's blocks) for CUDA tensors, the plain version for CPU
    tensors.  For an ensemble ``d packed`` is ``(K, P)``, each member's own,
    and ``d x`` the sum over members (the points are shared).  The
    workspace does not grow with ``n``
    (:meth:`TaylorPlan.backward_workspace`)."""
    if x.device.type == "cpu":
        return fused_taylor_backward_plain(packed, x, g, plan)
    n = check_packed(packed, x, plan)
    K = members(packed)
    check_operand("g", g, _stream_shape(packed, n, plan))
    d_packed = torch.empty(packed.shape, dtype=x.dtype, device=x.device)
    dx = torch.empty((K, n, plan.in_dim), dtype=x.dtype, device=x.device)
    if n == 0:
        return d_packed.zero_(), dx[0].zero_()
    grid, save_floats, partial_floats = plan.backward_workspace(
        n, _sm_count(x.device), K)
    saves = torch.empty((save_floats,), dtype=x.dtype, device=x.device)
    partials = torch.empty((partial_floats,), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.pdt_taylor_backward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        g.data_ptr(), saves.data_ptr(), partials.data_ptr(),
        d_packed.data_ptr(), dx.data_ptr(), n, plan.n_params, plan.n_streams,
        plan.wmax, plan.out_dim, grid, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_taylor_backward", err)
    fused_taylor_backward.launches += 1
    return d_packed, (dx[0] if K == 1 else dx.sum(0))


# Wrapper calls; a CUDA-graph replay makes none.
fused_taylor_backward.launches = 0


def fused_taylor_backward_plain(packed, x, g, plan):
    """The VJP of :func:`fused_taylor_forward_plain` by autograd."""
    with torch.enable_grad():
        p = packed.detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        out = fused_taylor_forward_plain(p, xx, plan)
        d_packed, dx = torch.autograd.grad(out, (p, xx), g)
    return d_packed, dx


def fused_taylor_jvp(packed, x, v, plan):
    """``(streams, tangent)``: the streams of :func:`fused_taylor_forward`
    and their tangent for the tangent ``v`` of ``packed`` (same layout), each
    ``(n, n_streams * out_dim)``: the CUDA tangent kernel for CUDA tensors,
    the plain version for CPU tensors.  The kernel takes every plan
    (``TaylorPlan.jvp_tile`` points a tile); its grid is what the card holds
    at once (:func:`jvp_blocks_per_sm`), shared by an ensemble's members
    (``v`` then ``(K, P)`` as the weights, each output ``(K, n, ...)``)."""
    if x.device.type == "cpu":
        return fused_taylor_jvp_plain(packed, x, v, plan)
    n = check_packed(packed, x, plan)
    check_operand("v", v, tuple(packed.shape))
    shape = _stream_shape(packed, n, plan)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    tangent = torch.empty(shape, dtype=x.dtype, device=x.device)
    if n == 0:
        return out, tangent
    lib = _lib()
    K = members(packed)
    grid, _ = plan.jvp_launch_shape(n, _sm_count(x.device),
                                    jvp_blocks_per_sm(plan, x.device), K)
    err = lib.pdt_taylor_jvp(
        x.data_ptr(), packed.data_ptr(), v.data_ptr(),
        plan.device_table(x.device).data_ptr(), out.data_ptr(),
        tangent.data_ptr(), n, plan.n_params, plan.n_streams, plan.wmax,
        plan.out_dim, plan.jvp_tile, int(plan.jvp_resident), grid, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_taylor_jvp", err)
    fused_taylor_jvp.launches += 1
    return out, tangent


# Wrapper calls; a CUDA-graph replay makes none.
fused_taylor_jvp.launches = 0


def fused_taylor_jvp_plain(packed, x, v, plan):
    """``torch.func.jvp`` of :func:`fused_taylor_forward_plain` with
    respect to ``packed``."""
    x = x.detach()
    return torch.func.jvp(
        lambda p: fused_taylor_forward_plain(p, x, plan),
        (packed.detach(),), (v.detach(),))


def _second_order_needed(ctx, i):
    """Whether the running backward pass will use the gradient of input
    ``i`` of the node ``ctx`` (an input that requires grad may still lie
    off the path to what ``torch.autograd.grad`` was asked for)."""
    node = ctx.next_functions[i][0]
    return node is not None and torch._C._will_engine_execute_node(node)


class FusedTaylor(torch.autograd.Function):
    """The fused traversal as a differentiable op: forward and backward
    each run :func:`fused_taylor_forward` / :func:`fused_taylor_backward`,
    and the backward is itself differentiable with respect to its
    cotangent (:class:`_FusedTaylorAdjoint`)."""

    @staticmethod
    def forward(ctx, packed, x, plan):
        ctx.save_for_backward(packed, x)
        ctx.plan = plan
        return fused_taylor_forward(packed, x, plan)

    @staticmethod
    def backward(ctx, g):
        packed, x = ctx.saved_tensors
        # Views, so that the adjoint's inputs are never leaves: the engine
        # can tell whether it runs a non-leaf node under autograd.grad.
        d_packed, dx = _FusedTaylorAdjoint.apply(
            packed.view_as(packed), x.view_as(x), g.contiguous(), ctx.plan)
        return d_packed, (dx if ctx.needs_input_grad[1] else None), None


class _FusedTaylorAdjoint(torch.autograd.Function):
    """``(d packed, d x) = J^T g`` of the traversal, linear in ``g``.  Its
    own backward takes the cotangent ``v`` of ``d packed`` to ``J v`` by
    the tangent kernel (:func:`fused_taylor_jvp`); the derivatives it does
    not compute — with respect to the weights and the points (third-order
    terms of the traversal), and ``J_x`` of a cotangent of ``d x`` — raise
    when a backward pass needs them, and it is not differentiable again."""

    @staticmethod
    def forward(ctx, packed, x, g, plan):
        ctx.save_for_backward(packed, x)
        ctx.plan = plan
        ctx.set_materialize_grads(False)
        return fused_taylor_backward(packed, x, g, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, v_packed, v_x):
        for i, name in ((0, "the packed weights"), (1, "the points")):
            if ctx.needs_input_grad[i] and _second_order_needed(ctx, i):
                raise NotImplementedError(
                    "the fused Taylor op has no second derivative with "
                    f"respect to {name}; only J.v of its adjoint (the "
                    "cotangent's direction) is implemented")
        if v_x is not None:
            raise NotImplementedError(
                "the fused Taylor op has no tangent with respect to its "
                "points: J.v takes the weights' direction only")
        if v_packed is None or not ctx.needs_input_grad[2]:
            return None, None, None, None
        packed, x = ctx.saved_tensors
        _, tangent = fused_taylor_jvp(packed, x, v_packed.contiguous(),
                                      ctx.plan)
        return None, None, tangent, None


def split_streams(out, plan):
    """``(V, {(d,): T_d, (a, b): S_ab})`` from the stacked stream columns
    (the last axis)."""
    k = plan.out_dim
    taps = {}
    for i, d in enumerate(plan.firsts):
        taps[(d,)] = out[..., (1 + i) * k:(2 + i) * k]
    for j, pair in enumerate(plan.pairs):
        s = 1 + len(plan.firsts) + j
        taps[tuple(pair)] = out[..., s * k:(s + 1) * k]
    return out[..., :k], taps


def fused_taylor_taps(packed, x, plan):
    """``(V, taps)`` of the chain through :class:`FusedTaylor`."""
    return split_streams(FusedTaylor.apply(packed, x.contiguous(), plan),
                         plan)
