"""AdamW with global-norm clipping over a pytree of tensors, and its
ZeRO-1 sharding.

The port of ``repro.optim.adamw``: moments in f32, the update on f32
upcasts of the parameters (bf16 or f32), cast back to each parameter's
dtype; ``step`` an int32 tensor.  Pytrees (dicts, lists, tuples: GNN MLP
layers are ``(w, b)`` tuples) are flattened with ``torch.utils._pytree``.
No host read: the global norm stays a tensor.

ZeRO-1 (``opt_state_shardings``): each moment extends its parameter's
sharding (:mod:`repro_torch.launch.sharding`) by splitting its first free
dimension that the data axes divide over them, as the reference's
``_zero1_sharding``.  ``adamw_update(..., mom_shardings=,
param_shardings=)`` then runs on each rank's blocks: it reduce-scatters
the gradients (partial sums over the data axes a parameter is not split
on) into the moment blocks (all-reduces those whose moments have no free
dimension), clips by the global norm of the distinct blocks (a block held
by several ranks counts once), updates the moments and its slice of the
parameters there, and all-gathers the new parameters back to their own
sharding.
"""

from __future__ import annotations

import torch

from repro_torch.compat import pytree
from repro_torch.core import collectives as coll
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import (NamedSharding, PartitionSpec, block_index,
                                         replicated_axes, spec_axes)


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
    mom_shardings=None,
    param_shardings=None,
):
    """One AdamW step: clip, update the moments and the parameters.
    Returns (new params, new state, global norm); nothing is changed in
    place.  With ``mom_shardings`` and ``param_shardings`` (trees of
    :class:`~repro_torch.launch.sharding.NamedSharding`) the tensors are
    this rank's blocks and the step is ZeRO-1's (see the module's
    docstring); every rank of the mesh calls it."""
    if mom_shardings is not None:
        return _sharded_update(params, grads, state, mom_shardings, param_shardings,
                               lr, b1, b2, eps, weight_decay, max_norm)
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


def _zero_dim(ps: NamedSharding, ms: NamedSharding, ndim: int) -> int | None:
    """The dimension the moment sharding splits over the data axes and the
    parameter's does not (None when they are the same)."""
    pe, me = ps.entries(ndim), ms.entries(ndim)
    diff = [i for i, (a, b) in enumerate(zip(pe, me)) if a != b]
    if not diff:
        return None
    if len(diff) > 1 or pe[diff[0]] is not None:
        raise ValueError(f"moment sharding {ms!r} is not ZeRO-1 of {ps!r}")
    return diff[0]


def _sharded_update(params, grads, state, mom_shardings, param_shardings,
                    lr, b1, b2, eps, weight_decay, max_norm):
    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_mu = pytree.tree_leaves(state["mu"])
    flat_nu = pytree.tree_leaves(state["nu"])
    flat_ms = pytree.tree_leaves(mom_shardings)
    flat_ps = pytree.tree_leaves(param_shardings)
    if not (len(flat_p) == len(flat_g) == len(flat_ms) == len(flat_ps)):
        raise ValueError("params, grads and shardings differ in structure")
    mesh = flat_ms[0].mesh
    dp = data_axes(mesh)
    coords = mesh.coords

    # 1. the gradients made whole in the moment blocks
    blocks, dims = [], []
    for p, g, ps, ms in zip(flat_p, flat_g, flat_ps, flat_ms):
        k = _zero_dim(ps, ms, p.dim())
        if k is None:
            red = tuple(a for a in dp if a not in spec_axes(ps, p.dim()))
            g = coll.all_reduce_raw(g, mesh, red) if red else g
        else:
            g = coll.reduce_scatter_raw(g, mesh, ms.entries(p.dim())[k], k)
        blocks.append(g)
        dims.append(k)

    # 2. the global norm over the distinct blocks: a block counts on the
    # ranks at coordinate 0 of every axis it is replicated along
    def weight(ms, ndim):
        return float(all(coords[a] == 0 for a in replicated_axes(ms, ndim)))

    sq = sum(torch.sum(torch.square(g.float())) * weight(ms, p.dim())
             for g, ms, p in zip(blocks, flat_ms, flat_p))
    sq = coll.all_reduce_raw(sq, mesh, mesh.axis_names)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    # 3. the moments and this rank's slice of the parameters
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, ms, k in zip(flat_p, blocks, flat_mu, flat_nu, flat_ms, dims):
        g = (g.float() * scale).to(g.dtype).float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if k is not None:
            n = mu.shape[k]
            p = p.narrow(k, block_index(ms, coords, p.dim())[k] * n, n)
        pf = p.float()
        pf = pf - lr * (u + weight_decay * pf)
        out = pf.to(p.dtype)
        # 4. back to the parameter's own sharding
        if k is not None:
            out = coll.all_gather_raw(out, mesh, ms.entries(p.dim())[k], k)
        new_p.append(out)
        new_mu.append(mu)
        new_nu.append(nu)
    mu_spec = pytree.tree_structure(state["mu"])
    return (pytree.tree_unflatten(new_p, spec),
            {"mu": pytree.tree_unflatten(new_mu, mu_spec),
             "nu": pytree.tree_unflatten(new_nu, mu_spec), "step": step}, gnorm)


def _zero1_sharding(ns: NamedSharding, shape, mesh, dp: tuple) -> NamedSharding:
    """Extend a parameter sharding with data-axis sharding over a free
    dimension (ZeRO-1): the first dimension that is unsharded and that the
    data axes' size divides (and is at least)."""
    if not dp:
        return ns
    ndim = len(shape)
    if spec_axes(ns, ndim) & set(dp):
        return ns  # already dp-sharded (FSDP parameters)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    spec = list(ns.spec) + [None] * (ndim - len(ns.spec))
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dp_size == 0 and dim >= dp_size:
            spec[i] = dp if len(dp) > 1 else dp[0]
            return NamedSharding(mesh, PartitionSpec(*spec))
    return ns  # too small to shard further: stays the param sharding


def opt_state_shardings(param_shardings, param_shapes, mesh, dp=("pod", "data")) -> dict:
    """Shardings of the AdamW state given the parameters' (and their
    :class:`~repro_torch.launch.sharding.ShapeDtype`s or tensors)."""
    dp = tuple(a for a in dp if a in mesh.axis_names)
    mom = pytree.tree_map(lambda ns, sh: _zero1_sharding(ns, tuple(sh.shape), mesh, dp),
                          param_shardings, param_shapes)
    return {"mu": mom, "nu": mom, "step": NamedSharding(mesh, PartitionSpec())}


def adamw_init_blocks(param_shapes, mom_shardings, device) -> dict:
    """The AdamW state of a sharded run on this rank: zero moments of each
    moment sharding's block of the parameter's global shape
    (:class:`~repro_torch.launch.sharding.ShapeDtype`s)."""
    from repro_torch.launch.sharding import shard_shape

    def zeros(sh, ms):
        return torch.zeros(shard_shape(sh.shape, ms), dtype=torch.float32, device=device)

    mom = pytree.tree_map(zeros, param_shapes, mom_shardings)
    return {"mu": mom, "nu": pytree.tree_map(torch.zeros_like, mom),
            "step": torch.zeros((), dtype=torch.int32, device=device)}
