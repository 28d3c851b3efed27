"""AdamW with global-norm clipping over a pytree of tensors.

The port of ``repro.optim.adamw``'s update on one device: moments in f32,
the update on f32 upcasts of the parameters (bf16 or f32), cast back to
each parameter's dtype; ``step`` an int32 tensor.  Pytrees (dicts, lists,
tuples: GNN MLP layers are ``(w, b)`` tuples) are flattened with
``torch.utils._pytree``.  No host read: the global norm stays a tensor.
The reference's ZeRO-1 moment shardings (``opt_state_shardings``) wait for
``param_shardings`` (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = pytree.tree_leaves(params)
    return {
        "mu": pytree.tree_map(zeros, params),
        "nu": pytree.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else "cpu"),
    }


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by ``min(1, max_norm / max(norm, 1e-9))`` in f32 and
    cast back, and the global norm (f32 tensor)."""
    leaves = pytree.tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(
    params,
    grads,
    state: dict,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_norm: float = 1.0,
):
    """One AdamW step: clip, update the moments and the parameters.
    Returns (new params, new state, global norm); nothing is changed in
    place."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t

    def upd(p, g, mu, nu):
        g = g.float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        pf = p.float()
        pf = pf - lr * (u + weight_decay * pf)
        return pf.to(p.dtype), mu, nu

    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_mu = pytree.tree_leaves(state["mu"])
    flat_nu = pytree.tree_leaves(state["nu"])
    out = [upd(p, g, mu, nu) for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu,
                                                    strict=True)]

    def unflat(i):
        return pytree.tree_unflatten([o[i] for o in out], spec)

    return unflat(0), {"mu": unflat(1), "nu": unflat(2), "step": step}, gnorm
