"""Fused layout-MLP forward — the kernel for Hopper and its plain PyTorch
version.

Counterpart of ``pydens_tpu/ops/pallas_mlp.py`` (``make_fused_mlp_forward``):
the forward of an ``f c a R +`` chain, skip stack included, with the
weights resident on-chip and the activations never leaving it.  It carries
``Model.predict_apply``.

:func:`fused_mlp_forward` launches ``csrc/fused_mlp.cu`` for CUDA tensors
(or raises) and takes :func:`fused_mlp_forward_plain` only for CPU tensors;
its ``launches`` attribute counts kernel launches.  It is an inference op:
it has no backward and refuses inputs that require grad.
"""

from __future__ import annotations

import torch

from ._build import (MAX_SHARED_BYTES, check_operand, launch_checked,
                     load_library)
from .fused_taylor import SIGMOID, SIN, TANH, act_kind

__all__ = ["supports", "MlpPlan", "fused_mlp_forward",
           "fused_mlp_forward_plain"]

_POINTS_PER_BLOCK = 64  # csrc/fused_mlp.cu POINTS_PER_BLOCK
_KINDS = {"dense": 0, "act": 1, "push": 2, "add": 3}
_SIGMA = {TANH: torch.tanh, SIGMOID: torch.sigmoid, SIN: torch.sin}


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


def _mlp_smem_bytes(n_params, wmax, max_stack):
    return 4 * (n_params + (2 + max_stack) * wmax * _POINTS_PER_BLOCK)


def supports(tokens, acts, layer_shapes, in_dim, dtype=torch.float32):
    """Whether the fused MLP kernel covers this chain: tokens ``f c a R +``,
    activations tanh, sigmoid or sin, float32, and weights plus state that
    fit one block's shared memory."""
    if dtype != torch.float32:
        return False
    if any(t not in ("f", "c", "a", "R", "+") for t in tokens):
        return False
    if any(act_kind(a) is None for a in acts):
        return False
    _, n_params, wmax, max_stack = _mlp_ops(tokens, acts, layer_shapes,
                                            in_dim)
    return _mlp_smem_bytes(n_params, wmax, max_stack) <= MAX_SHARED_BYTES


class MlpPlan:
    """The op table and sizes of one chain for the MLP kernel."""

    def __init__(self, tokens, acts, layer_shapes, in_dim):
        if not supports(tokens, acts, layer_shapes, in_dim):
            raise ValueError("fused MLP kernel: unsupported layout")
        self.ops, self.n_params, self.wmax, self.max_stack = _mlp_ops(
            tokens, acts, layer_shapes, in_dim)
        self.in_dim = in_dim
        self.out_dim = layer_shapes[-1][1]
        self.table = [len(self.ops), in_dim, self.wmax, self.max_stack]
        for op in self.ops:
            self.table += [_KINDS[op[0]], *op[1:]]
        self._device_tables = {}

    def device_table(self, device):
        if device not in self._device_tables:
            self._device_tables[device] = torch.tensor(
                self.table, dtype=torch.int32, device=device)
        return self._device_tables[device]


def fused_mlp_forward(packed, x, plan):
    """The chain's output ``(n, out_dim)`` at points ``x``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if torch.is_grad_enabled() and (packed.requires_grad or x.requires_grad):
        raise RuntimeError("fused_mlp_forward has no backward; call it "
                           "under torch.no_grad()")
    if x.device.type == "cpu":
        return fused_mlp_forward_plain(packed, x, plan)
    n = x.shape[0]
    check_operand("x", x, (n, plan.in_dim))
    check_operand("packed", packed, (plan.n_params,))
    if packed.device != x.device:
        raise ValueError(f"packed weights on {packed.device}, points on "
                         f"{x.device}")
    out = torch.empty((n, plan.out_dim), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    if lib.pdt_mlp_points_per_block() != _POINTS_PER_BLOCK:
        raise RuntimeError("csrc/fused_mlp.cu and fused_mlp.py disagree on "
                           "the points per block")
    err = lib.pdt_mlp_forward(
        x.data_ptr(), packed.data_ptr(), plan.device_table(x.device).data_ptr(),
        out.data_ptr(), n, plan.n_params, plan.wmax, plan.max_stack,
        plan.out_dim, torch.cuda.current_stream(x.device).cuda_stream)
    launch_checked("pdt_mlp_forward", err)
    fused_mlp_forward.launches += 1
    return out


fused_mlp_forward.launches = 0


def fused_mlp_forward_plain(packed, x, plan):
    """The forward of :func:`fused_mlp_forward` in torch ops."""
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
