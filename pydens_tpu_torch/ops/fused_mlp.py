"""Fused layout-MLP forward — the kernel for Hopper and its plain PyTorch
version.

Counterpart of ``pydens_tpu/ops/pallas_mlp.py`` (``make_fused_mlp_forward``):
the forward of an ``f c a R +`` chain, skip stack included, with the
weights resident on-chip and the activations never leaving it.  It carries
``Model.predict_apply``.

:func:`fused_mlp_forward` launches ``csrc/fused_mlp.cu`` for CUDA tensors
(or raises) and takes :func:`fused_mlp_forward_plain` only for CPU tensors;
its ``launches`` attribute counts its wrapper calls (a CUDA-graph replay
makes none).  It is an inference op:
it has no backward and refuses inputs that require grad.
"""

from __future__ import annotations

import torch

from ._build import (MAX_SHARED_BYTES, check_packed, launch_checked,
                     load_library)
from .fused_taylor import (SIGMOID, SIN, TANH, _per_member, _sm_count,
                           act_kind)

__all__ = ["supports", "refusal", "MlpPlan", "fused_mlp_forward",
           "fused_mlp_forward_plain"]

# csrc/fused_mlp.cu: the tiles it is built for (largest first), THREADS,
# ROW_PAD.
TILES = (128, 64, 32)
THREADS = 128
_ROW_PAD = 4
_KINDS = {"dense": 0, "act": 1, "push": 2, "add": 3}
_SIGMA = {TANH: torch.tanh, SIGMOID: torch.sigmoid, SIN: torch.sin}
_BLOCKS_PER_SM = {}


def _mlp_ops(tokens, acts, layer_shapes, in_dim):
    """Op records ``(kind, width or K, N/act, w_off, b_off)`` of the chain,
    the packed-weight size, the widest state and the deepest skip stack."""
    ops, off, di, ai = [], 0, 0, 0
    width, wmax, depth, max_depth = in_dim, in_dim, 0, 0
    for tok in tokens:
        if tok in ("f", "c"):
            K, N = layer_shapes[di]
            ops.append(("dense", K, N, off, off + K * N))
            off += K * N + N
            width = N
            wmax = max(wmax, N)
            di += 1
        elif tok == "a":
            ops.append(("act", width, act_kind(acts[ai]), 0, 0))
            ai += 1
        elif tok == "R":
            ops.append(("push", width, 0, 0, 0))
            depth += 1
            max_depth = max(max_depth, depth)
        else:
            ops.append(("add", width, 0, 0, 0))
            depth -= 1
    return ops, off, wmax, max_depth


def _kernel_records(ops):
    """The kernel's op records (``csrc/fused_mlp.cu``, OP_INTS each) and the
    floats of its staged weights: a tanh or sigmoid right after a dense
    layer joins that layer's record, and each dense layer's weights are
    staged as ``K + 1`` rows of ``4 * ceil(N / 4)`` floats."""
    records, staged, i = [], 0, 0
    while i < len(ops):
        kind, a, b, w_off, _ = ops[i]
        if kind == "dense":
            act = -1
            if (i + 1 < len(ops) and ops[i + 1][0] == "act"
                    and ops[i + 1][2] in (TANH, SIGMOID)):
                act = ops[i + 1][2]
                i += 1
            records.append((0, a, b, w_off, staged, act))
            staged += (a + 1) * (-(-b // 4) * 4)
        else:
            records.append((_KINDS[kind], a, b, 0, 0, 0))
        i += 1
    return records, staged


def _mlp_smem_bytes(staged, in_dim, wmax, max_stack, tile):
    """Shared memory of one block — ``mlp_smem_floats`` of the CUDA source:
    the staged weights, a staging buffer of the tile's points and
    ``2 + max_stack`` state planes of ``wmax`` features x ``tile + 4``
    floats."""
    return 4 * (staged + -(-tile * in_dim // 4) * 4
                + (2 + max_stack) * wmax * (tile + _ROW_PAD))


def _tile_for(staged, in_dim, wmax, max_stack):
    """The largest tile whose block fits the shared memory, or None."""
    for tile in TILES:
        if _mlp_smem_bytes(staged, in_dim, wmax, max_stack,
                           tile) <= MAX_SHARED_BYTES:
            return tile
    return None


def refusal(tokens, acts, layer_shapes, in_dim, dtype=torch.float32,
            adaptive=False):
    """Why the fused MLP kernel does not cover this chain, or None if it
    does: tokens ``f c a R +``, activations tanh, sigmoid or sin, no
    adaptive-activation slopes, float32, and staged weights plus a
    32-point tile's state that fit one block's shared memory."""
    if dtype != torch.float32:
        return f"dtype {dtype}: the kernel computes in float32"
    if adaptive:
        return "adaptive activation slopes: the kernel has no slope operand"
    bad = sorted({t for t in tokens if t not in ("f", "c", "a", "R", "+")})
    if bad:
        return f"tokens {bad}: the kernel runs f, c, a, R and + only"
    if any(act_kind(a) is None for a in acts):
        return "an activation other than tanh, sigmoid or sin"
    ops, _, wmax, max_stack = _mlp_ops(tokens, acts, layer_shapes, in_dim)
    _, staged = _kernel_records(ops)
    if _tile_for(staged, in_dim, wmax, max_stack) is None:
        need = _mlp_smem_bytes(staged, in_dim, wmax, max_stack, TILES[-1])
        return (f"weights and state need {need} bytes of shared memory at a "
                f"{TILES[-1]}-point tile; one block has {MAX_SHARED_BYTES}")
    return None


def supports(tokens, acts, layer_shapes, in_dim, dtype=torch.float32,
             adaptive=False):
    """Whether the fused MLP kernel covers this chain (:func:`refusal`)."""
    return refusal(tokens, acts, layer_shapes, in_dim, dtype,
                   adaptive) is None


class MlpPlan:
    """The op table and sizes of one chain for the MLP kernel."""

    def __init__(self, tokens, acts, layer_shapes, in_dim):
        reason = refusal(tokens, acts, layer_shapes, in_dim)
        if reason is not None:
            raise ValueError(f"fused MLP kernel: unsupported layout: {reason}")
        self.ops, self.n_params, self.wmax, self.max_stack = _mlp_ops(
            tokens, acts, layer_shapes, in_dim)
        records, self.staged = _kernel_records(self.ops)
        self.in_dim = in_dim
        self.out_dim = layer_shapes[-1][1]
        self.tile = _tile_for(self.staged, in_dim, self.wmax, self.max_stack)
        self.smem_bytes = _mlp_smem_bytes(self.staged, in_dim, self.wmax,
                                          self.max_stack, self.tile)
        self.table = [len(records), in_dim, self.wmax, self.max_stack,
                      self.staged]
        for rec in records:
            self.table += rec
        self._device_tables = {}

    def launch_shape(self, n, sm_count, blocks_per_sm, n_members=1):
        """The grid of a launch over ``n`` points (blocks a member, for
        each of ``n_members`` ensemble members on the grid's second axis):
        persistent blocks, the ``blocks_per_sm`` on each of ``sm_count``
        SMs shared by the members (at least one each), at most one per
        tile."""
        return _per_member(sm_count * blocks_per_sm, -(-n // self.tile),
                           n_members)

    def kernel_args(self):
        """``(staged, in_dim, wmax, max_stack, tile)``: the sizes the C
        entries take."""
        return (self.staged, self.in_dim, self.wmax, self.max_stack,
                self.tile)

    def device_table(self, device):
        if device not in self._device_tables:
            self._device_tables[device] = torch.tensor(
                self.table, dtype=torch.int32, device=device)
        return self._device_tables[device]


def _blocks_per_sm(lib, plan, device):
    """Blocks of this plan's launch that one SM holds at once (the CUDA
    occupancy calculator, cached per device and sizes)."""
    key = (device, plan.kernel_args())
    if key not in _BLOCKS_PER_SM:
        blocks = lib.pdt_mlp_blocks_per_sm(*plan.kernel_args())
        if blocks <= 0:
            raise RuntimeError("pdt_mlp_blocks_per_sm: no block of the MLP "
                               f"kernel fits an SM (code {blocks})")
        _BLOCKS_PER_SM[key] = blocks
    return _BLOCKS_PER_SM[key]


def fused_mlp_forward(packed, x, plan):
    """The chain's output ``(n, out_dim)`` at points ``x``, or ``(K, n,
    out_dim)`` for an ensemble's ``(K, P)`` packed weights (one launch for
    every member): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if torch.is_grad_enabled() and (packed.requires_grad or x.requires_grad):
        raise RuntimeError("fused_mlp_forward has no backward; call it "
                           "under torch.no_grad()")
    if x.device.type == "cpu":
        return fused_mlp_forward_plain(packed, x, plan)
    n = check_packed(packed, x, plan)
    out = torch.empty(tuple(packed.shape[:-1]) + (n, plan.out_dim),
                      dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    K = 1 if packed.dim() == 1 else packed.shape[0]
    grid = plan.launch_shape(n, _sm_count(x.device),
                             _blocks_per_sm(lib, plan, x.device), K)
    err = lib.pdt_mlp_forward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        out.data_ptr(), n, *plan.kernel_args(), plan.out_dim, plan.n_params,
        grid, K, torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_mlp_forward", err)
    fused_mlp_forward.launches += 1
    return out


# Wrapper calls; a CUDA-graph replay makes none.
fused_mlp_forward.launches = 0


def fused_mlp_forward_plain(packed, x, plan):
    """The forward of :func:`fused_mlp_forward` in torch ops; an
    ensemble's, member by member."""
    if packed.dim() == 2:
        return torch.stack([fused_mlp_forward_plain(p, x, plan)
                            for p in packed.unbind(0)])
    h = x
    stack = []
    for kind, a, b, w_off, b_off in plan.ops:
        if kind == "dense":
            h = h @ packed[w_off:w_off + a * b].view(a, b) \
                + packed[b_off:b_off + b]
        elif kind == "act":
            h = _SIGMA[b](h)
        elif kind == "push":
            stack.append(h)
        else:
            h = h + stack.pop()
    return h
