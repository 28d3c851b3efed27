"""int8 error-feedback gradient compression for data-parallel exchange.

The port of ``repro.optim.compression``.  Compressing gradients to int8
with per-tensor scales cuts the bytes of the cross-node all-reduce 4x
against f32.  Plain quantisation biases the update, so the residual of
what the wire lost is carried to the next step (Seide et al. '14;
Karimireddy et al. '19):

    q_t  = Q(g_t + e_t)          # quantise gradient + carried residual
    e_t1 = (g_t + e_t) - D(q_t)  # residual of what the wire lost

``compressed_grad_exchange`` runs over a ``torch.distributed`` process
group (:mod:`repro_torch.launch.mesh`), which stands for the reference's
named ``pod`` axis; like the reference's ``psum``, it all-reduces the
dequantised values.  ``quantize_int8`` and ``compress_with_feedback`` are
pure.  ``torch.round``, like ``jnp.round``, rounds halves to even.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.compat import pytree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params):
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_with_feedback(g: torch.Tensor, e: torch.Tensor):
    """One tensor: returns ((int8 payload, f32 scale), new residual)."""
    gf = g.float() + e
    q, s = quantize_int8(gf)
    new_e = gf - dequantize_int8(q, s)
    return (q, s), new_e


def compressed_grad_exchange(grads, residuals, group=None):
    """Error-feedback int8 mean all-reduce over ``group`` (the default
    process group when None): every rank calls it with its own gradients
    and residuals.  The int8 payload and its scale are what a compressed
    wire would carry; the all-reduce sums the dequantised values.  Returns
    (mean gradients in each gradient's dtype, new residuals)."""
    n = dist.get_world_size(group)

    def one(g, e):
        (q, s), new_e = compress_with_feedback(g, e)
        total = dequantize_int8(q, s)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total / n).to(g.dtype), new_e

    flat_g, spec = pytree.tree_flatten(grads)
    flat_e = pytree.tree_leaves(residuals)
    out = [one(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    mean = pytree.tree_unflatten([m for m, _ in out], spec)
    new_res = pytree.tree_unflatten([e for _, e in out], spec)
    return mean, new_res


def wire_bytes(params) -> tuple[int, int]:
    """(compressed, f32) bytes per exchange."""
    leaves = pytree.tree_leaves(params)
    comp = sum(p.numel() + 4 for p in leaves)  # int8 payload + scale
    full = sum(4 * p.numel() for p in leaves)
    return comp, full
