"""The plain reference for REW: what the store and rho must be, computed
naively with plain PyTorch operations from the explicit facts and the
rules' text, on whichever device the caller names (the card after a run's
window, the CPU in the tests).

The answer REW owes (the paper's Theorem 1) is the closure of the facts
under the rules and owl:sameAs's own axioms, each resource replaced by its
representative: rho maps every resource to the least id of its owl:sameAs
clique, the store holds every fact of the closure rewritten by rho, and
``<c, owl:sameAs, c>`` for every resource ``c`` it mentions (owl:sameAs
itself included).  This module computes that set by brute force: every
round evaluates every rule over the whole store (no delta, no index, no
marking), merges the owl:sameAs pairs found by a union-find over plain
arrays, rewrites the whole store and adds the reflexive facts, until
nothing changes.  It shares no code with the program under test.

``materialise(..., sweep=False)`` is the check's control for REW: the
store is not rewritten after a merge, so facts stored before it keep
their outdated resources (the guarantee that every stored fact is
rho-normal is broken).  :func:`delete_without_retraction` is the control
for updates.
"""

from __future__ import annotations

import numpy as np
import torch

from .rules import SAME_AS, parse_rules

BITS = 21
_MASK = (1 << BITS) - 1
_CROSS_LIMIT = 1 << 27  # rows of a join with no shared variable
I64 = torch.int64


def pack(rows: torch.Tensor) -> torch.Tensor:
    """(n, 3) ids -> int64 keys, (s, p, o) order."""
    r = rows.reshape(-1, 3).to(I64)
    return (r[:, 0] << (2 * BITS)) | (r[:, 1] << BITS) | r[:, 2]


def unpack(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([keys >> (2 * BITS), (keys >> BITS) & _MASK, keys & _MASK],
                       dim=1).to(torch.int32)


def merge(rho: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """rho with the cliques of ``pairs`` (m, 2) joined, each to its least
    id: hook the larger root under the smaller, jump to the roots, until
    every pair's ends share a root."""
    lab = rho.to(I64)
    a, b = pairs[:, 0].to(I64), pairs[:, 1].to(I64)
    while True:
        while True:  # every entry on its root
            nxt = lab[lab]
            if torch.equal(nxt, lab):
                break
            lab = nxt
        ra, rb = lab[a], lab[b]
        open_ = ra != rb
        if not bool(open_.any()):
            return lab.to(torch.int32)
        lo = torch.minimum(ra[open_], rb[open_])
        hi = torch.maximum(ra[open_], rb[open_])
        lab = lab.scatter_reduce(0, hi, lo, reduce="amin")


def _atom_bindings(atom, cols) -> tuple[dict, int]:
    """The rows of ``cols`` (s, p, o) that match ``atom``, as variable ->
    values."""
    keep = torch.ones_like(cols[0], dtype=torch.bool)
    first: dict[int, int] = {}
    for pos, t in enumerate(atom):
        if t >= 0:
            keep &= cols[pos] == t
        elif t in first:
            keep &= cols[pos] == cols[first[t]]
        else:
            first[t] = pos
    idx = torch.nonzero(keep).reshape(-1)
    return {v: cols[pos][idx] for v, pos in first.items()}, int(idx.shape[0])


def _join(left: dict, n_left: int, right: dict, n_right: int) -> tuple[dict, int]:
    """Every pair of a left and a right row that agree on their shared
    variables."""
    dev = next(iter(right.values())).device
    shared = [v for v in right if v in left]
    if not shared:
        if n_left * n_right > _CROSS_LIMIT:
            raise ValueError(f"a join with no shared variable: {n_left} x {n_right}")
        li = torch.arange(n_left, device=dev).repeat_interleave(n_right)
        ri = torch.arange(n_right, device=dev).repeat(n_left)
    else:
        def key(t, n):
            k = torch.zeros(n, dtype=I64, device=dev)
            for v in shared:
                k = (k << BITS) | t[v].to(I64)
            return k

        kl, kr = key(left, n_left), key(right, n_right)
        sk, order = torch.sort(kr, stable=True)
        lo = torch.searchsorted(sk, kl)
        cnt = torch.searchsorted(sk, kl, right=True) - lo
        total = int(cnt.sum())
        li = torch.arange(n_left, device=dev).repeat_interleave(cnt)
        start = (torch.cumsum(cnt, 0) - cnt).repeat_interleave(cnt)
        ri = order[lo.repeat_interleave(cnt) + torch.arange(total, device=dev) - start]
    out = {v: x[li] for v, x in left.items()}
    out.update({v: x[ri] for v, x in right.items() if v not in left})
    return out, int(li.shape[0])


def eval_rule(head, body, rows: torch.Tensor) -> torch.Tensor:
    """Every head instance of the rule over ``rows`` (n, 3), as (m, 3)."""
    cols = (rows[:, 0], rows[:, 1], rows[:, 2])
    bind, n = _atom_bindings(body[0], cols)
    for atom in body[1:]:
        right, m = _atom_bindings(atom, cols)
        bind, n = _join(bind, n, right, m)
    out = torch.empty((n, 3), dtype=torch.int32, device=rows.device)
    for pos, t in enumerate(head):
        out[:, pos] = t if t >= 0 else bind[t]
    return out


def _reflexive(rows: torch.Tensor, n: int) -> torch.Tensor:
    """``<c, owl:sameAs, c>`` for every resource of ``rows`` and owl:sameAs."""
    seen = torch.bincount(rows.reshape(-1).to(I64), minlength=n) > 0
    seen[SAME_AS] = True
    res = torch.nonzero(seen).reshape(-1).to(torch.int32)
    return torch.stack([res, torch.full_like(res, SAME_AS), res], dim=1)


def _store(rows: torch.Tensor, n: int) -> torch.Tensor:
    return torch.unique(pack(torch.cat([rows, _reflexive(rows, n)])))


def _union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.unique(torch.cat([a, b]))


def materialise(facts, rule_text: list[str], ids: dict[str, int], n_resources: int,
                sweep: bool = True, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """``(keys, rho)``: the store as sorted distinct packed keys and rho
    (int32, ``n_resources`` long, at least every id the facts use), on
    ``device``.

    Every round evaluates every rule over the whole store.  A round that
    merges rewrites the whole store under the new rho and makes it anew;
    one that does not adds the facts not yet stored (and their reflexive
    facts); the fixpoint is a round that adds nothing and merges nothing.
    """
    rules = parse_rules(rule_text, ids)
    facts = torch.as_tensor(np.asarray(facts, np.int32).reshape(-1, 3), device=device)
    n = max(int(n_resources), int(facts.max()) + 1 if facts.numel() else 0)
    rho = torch.arange(n, dtype=torch.int32, device=device)
    named = sorted({t for h, b in rules for atom in (h, *b) for t in atom if t >= 0})
    keys = _store(facts, n)
    while True:
        rows = unpack(keys)
        consts = dict(zip(named, rho[named].tolist()))
        heads = [eval_rule(tuple(consts[t] if t >= 0 else t for t in h),
                           [tuple(consts[t] if t >= 0 else t for t in a) for a in b], rows)
                 for h, b in rules]
        heads = torch.cat(heads) if heads else rows[:0]
        both = torch.cat([rows, heads])
        eq = (both[:, 1] == SAME_AS) & (both[:, 0] != both[:, 2])
        if bool(eq.any()):
            rho_new = merge(rho, both[eq][:, [0, 2]])
            if not torch.equal(rho_new, rho):
                rho = rho_new
                r = rho.to(I64)
                if sweep:
                    keys = _store(r[both.to(I64)], n)
                else:  # the control: the stored facts keep their old form
                    keys = _union(keys, _store(r[heads.to(I64)], n))
                continue
        hk = torch.unique(pack(heads))
        pos = torch.searchsorted(keys, hk).clamp(max=max(keys.shape[0] - 1, 0))
        fresh = hk[keys[pos] != hk] if keys.shape[0] else hk
        if fresh.shape[0] == 0:
            return keys, rho
        keys = _union(keys, _store(unpack(fresh), n))


def delete_without_retraction(keys: torch.Tensor, rho: torch.Tensor,
                              rows) -> tuple[torch.Tensor, torch.Tensor]:
    """The control for updates: a delete that takes the deleted facts'
    normal forms out of the store and keeps everything derived from them
    and rho (the guarantee that the store is the closure of the explicit
    facts left is broken)."""
    rows = torch.as_tensor(np.asarray(rows, np.int32), device=keys.device)
    nf = pack(rho.to(I64)[rows.to(I64)])
    return keys[~torch.isin(keys, nf)], rho
