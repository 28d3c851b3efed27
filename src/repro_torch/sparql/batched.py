"""Batched BGP execution against device-resident snapshots.

The port of ``repro.sparql.batched``, the serving tier's query path.  A
standing service drains a *queue* of queries per epoch, and most of them
share a handful of BGP shapes; queued queries are grouped by **shape
signature** (the BGP with variables renumbered by first occurrence and
constants abstracted to slots) and each group of up to ``max_batch`` is
matched in one pass over explicit (B, W) tensors: B queries of the group,
W binding rows each.  The reference builds one matcher per shape and runs
it under ``jax.vmap``; here the batch dimension is explicit and nothing is
compiled.

The matcher is the engine's index-probe join re-targeted at a published
:class:`~repro_torch.core.engine.StoreSnapshot`, which keeps the live rows
in two sorted packed-key orders, ``(s,p,o)`` and ``(p,o,s)``: every atom
whose bound positions form a prefix of either order is a range probe, and
every probe is one call of the prefix form of the search kernel
(:func:`repro_torch.kernels.ops.prefix_range_bounds`): the first probe's
all-constant prefixes as B rows, each later probe's as B·W rows.  Atoms
with no bound prefix under either order make the query **non-batchable**:
it falls back to the host matcher on the snapshot's host copy, as does a
shape group shorter than ``min_batch``, a query whose expansion overflows
W (flagged per query, never truncated) and a snapshot that is not on a
device.  Each group's answers come to the host in one copy.

Everything after the BGP match (FILTER/BIND steps, projection
multiplicities, clique expansion) is the host executor's
:func:`repro_torch.sparql.executor._finish`, shared verbatim, so the
batched and scalar paths can only differ in how solution rows are produced.

The search kernel counts only the keys it is given, where the reference's
``jnp.searchsorted`` on the padded snapshot counts the KEY_MAX padding too;
the two differ only for a prefix of all-(2^21-1) ids, whose high key is
KEY_MAX.  :func:`build_plan` never plans an empty prefix and ids stay below
2^21-1, so the answers agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.seminaive import Bindings
from repro_torch.core.terms import is_var
from repro_torch.kernels import ops

from .algebra import Query
from .executor import _Solutions, _finish, _normalise_query, evaluate_at

I32 = torch.int32
I64 = torch.int64

# the two published key orders: position scan sequences matching the packing
# of StoreSnapshot.d_keys ((s<<42)|(p<<21)|o) and d_keys_pos ((p<<42)|(o<<21)|s)
_ORDERS = (("spo", (0, 1, 2)), ("pos", (1, 2, 0)))


# ---------------------------------------------------------------------------
# shape signatures and probe plans (static, per shape; as the reference's)
# ---------------------------------------------------------------------------

def shape_signature(patterns) -> tuple[tuple, dict[int, int]]:
    """Canonical BGP shape: vars renumbered by first occurrence, constants
    abstracted to occurrence slots.

    Queries sharing a signature share one matcher pass; their constants
    become its batch dimension.  Returns ``(sig, varmap)`` where
    ``varmap`` maps the query's actual var ids to canonical ids.
    """
    varmap: dict[int, int] = {}
    sig = []
    for atom in patterns:
        parts = []
        for t in atom:
            if is_var(t):
                if t not in varmap:
                    varmap[t] = len(varmap)
                parts.append(("v", varmap[t]))
            else:
                parts.append("c")
        sig.append(tuple(parts))
    return tuple(sig), varmap


@dataclass(frozen=True)
class _Probe:
    """One planned atom: a range probe against one key order + post-filters."""

    order: str          # "spo" | "pos" — which snapshot view to probe
    atom: int           # original atom index (labels only)
    prefix: tuple       # leading key positions: ("const", slot) | ("var", cv)
    post_consts: tuple  # ((triple_pos, slot), ...) consts outside the prefix
    post_bound: tuple   # ((triple_pos, cv), ...) bound vars outside the prefix
    eq_pairs: tuple     # ((pos_a, pos_b), ...) repeated vars within the atom
    free: tuple         # ((cv, triple_pos), ...) vars first bound here


@dataclass(frozen=True)
class BatchPlan:
    sig: tuple
    probes: tuple
    n_consts: int
    var_order: tuple    # canonical var ids in binding order


def build_plan(sig) -> BatchPlan | None:
    """Greedy longest-bound-prefix atom ordering over the two key orders.

    At each step pick the remaining atom with the longest prefix of bound
    positions (const or already-bound var) under either published order —
    ties break to the earlier atom and the primary ``(s,p,o)`` order.  BGP
    join bags are atom-order independent (each solution row is one choice
    of matching triple per atom), so reordering is free; an atom with no
    bound prefix at its turn makes the shape non-batchable (``None``) —
    the batched path has no cartesian/scan fallback by design.
    """
    const_slot: dict[tuple[int, int], int] = {}
    for i, atom in enumerate(sig):
        for pos, t in enumerate(atom):
            if t == "c":
                const_slot[(i, pos)] = len(const_slot)
    remaining = list(range(len(sig)))
    bound: set[int] = set()
    var_order: list[int] = []
    probes = []
    while remaining:
        best = None  # (prefix_len, atom, order_name, scan_seq)
        for i in remaining:
            for name, seq in _ORDERS:
                plen = 0
                for pos in seq:
                    t = sig[i][pos]
                    if t == "c" or t[1] in bound:
                        plen += 1
                    else:
                        break
                if best is None or plen > best[0]:
                    best = (plen, i, name, seq)
        plen, i, name, seq = best
        if plen == 0:
            return None
        atom = sig[i]
        prefix_pos = set(seq[:plen])
        prefix = tuple(
            ("const", const_slot[(i, pos)]) if atom[pos] == "c"
            else ("var", atom[pos][1])
            for pos in seq[:plen]
        )
        post_consts, post_bound, eq_pairs, free = [], [], [], []
        first_pos: dict[int, int] = {}
        for pos in (0, 1, 2):
            t = atom[pos]
            if t == "c":
                if pos not in prefix_pos:
                    post_consts.append((pos, const_slot[(i, pos)]))
            else:
                cv = t[1]
                if cv in first_pos:
                    eq_pairs.append((first_pos[cv], pos))
                else:
                    first_pos[cv] = pos
                    if cv in bound:
                        if pos not in prefix_pos:
                            post_bound.append((pos, cv))
                    else:
                        free.append((cv, pos))
        probes.append(_Probe(
            name, i, prefix,
            tuple(post_consts), tuple(post_bound), tuple(eq_pairs),
            tuple(free),
        ))
        for cv, _ in free:
            bound.add(cv)
            var_order.append(cv)
        remaining.remove(i)
    return BatchPlan(sig, tuple(probes), len(const_slot), tuple(var_order))


# ---------------------------------------------------------------------------
# the matcher: B queries of one shape, W binding rows each
# ---------------------------------------------------------------------------

def _bgp(probes, var_order, W: int, d_tri, d_keys, d_tri_pos, d_keys_pos,
         consts):
    """Match B queries of one shape against a published snapshot.

    ``consts`` is the (B, n_consts) int32 table of the queries' constants.
    The reference's ``_bgp_one`` with its vmapped batch axis made explicit:
    the binding table starts as the single empty substitution and each
    probe expands it as :func:`repro_torch.core.engine._expand_join_index`
    does: the prefix range of every binding row (the search kernel's prefix
    form), a cumsum-enumerated gather of the matching rows, then mask-level
    post-filters for non-prefix constants, bound vars and repeated-var
    equality.  The first probe's prefix is all constants (nothing is bound
    yet), so it is B prefix queries and a plain range gather; each later
    probe is B·W prefix queries, whose output slots are assigned by marks
    at the exclusive offsets (a mark past W is dropped) and a cumsum.  A
    query whose step outputs more than W rows raises its overflow flag.

    Returns ``(out, valid, overflow)``: (B, V, W) int32 columns of the
    bound vars in ``var_order`` (V at least 1), (B, W) bool and (B,) bool.
    """
    B = consts.shape[0]
    dev = consts.device
    n_rows = d_keys.shape[0]
    j = torch.arange(W, device=dev)
    views = {"spo": (d_keys, d_tri), "pos": (d_keys_pos, d_tri_pos)}

    pr0 = probes[0]
    keys, tri = views[pr0.order]
    prefix = consts[:, [ref for _kind, ref in pr0.prefix]].contiguous()
    lo0, hi0 = ops.prefix_range_bounds(prefix, keys)
    n0 = (hi0 - lo0).clamp_min(0).to(I64)
    src = (lo0.to(I64)[:, None] + j).clamp_(0, n_rows - 1)
    rows = tri[src]
    ok = j < n0[:, None]
    for pos, slot in pr0.post_consts:
        ok &= rows[..., pos] == consts[:, slot, None]
    for a, b in pr0.eq_pairs:
        ok &= rows[..., a] == rows[..., b]
    cols = {cv: torch.where(ok, rows[..., pos], 0) for cv, pos in pr0.free}
    overflow = n0 > W
    valid = ok

    base = (torch.arange(B, device=dev) * W)[:, None]
    for pr in probes[1:]:
        keys, tri = views[pr.order]
        parts = [consts[:, ref, None].expand(B, W) if kind == "const"
                 else cols[ref] for kind, ref in pr.prefix]
        prefix = torch.stack(parts, dim=2).reshape(B * W, len(parts))
        lo, hi = ops.prefix_range_bounds(prefix, keys)
        lo = lo.view(B, W).to(I64)
        counts = torch.where(valid, (hi.view(B, W).to(I64) - lo).clamp_min(0), 0)
        cum = counts.cumsum(1) - counts  # exclusive
        total = counts.sum(1)
        marks = torch.zeros(B * W, dtype=I32, device=dev)
        marks.index_add_(0, (base + cum.clamp(max=W - 1)).view(-1),
                         (cum < W).view(-1).to(I32))
        seg = marks.view(B, W).cumsum(1) - 1
        within = j - cum.gather(1, seg)
        src = (lo.gather(1, seg) + within).clamp_(0, n_rows - 1)
        rows = tri[src]
        ok = (j < total[:, None]) & valid.gather(1, seg)
        for pos, slot in pr.post_consts:
            ok &= rows[..., pos] == consts[:, slot, None]
        for pos, cv in pr.post_bound:
            ok &= rows[..., pos] == cols[cv].gather(1, seg)
        for a, b in pr.eq_pairs:
            ok &= rows[..., a] == rows[..., b]
        new_cols = {cv: torch.where(ok, c.gather(1, seg), 0)
                    for cv, c in cols.items()}
        for cv, pos in pr.free:
            new_cols[cv] = torch.where(ok, rows[..., pos], 0)
        overflow |= total > W
        cols, valid = new_cols, ok
    if var_order:
        out = torch.stack([cols[cv] for cv in var_order], dim=1)
    else:
        out = torch.zeros((B, 1, W), dtype=I32, device=dev)  # validity carries it
    return out.to(I32), valid, overflow


# ---------------------------------------------------------------------------
# the batch executor (host orchestration)
# ---------------------------------------------------------------------------

class BatchedExecutor:
    """Drain a query list against one snapshot in shape groups.

    Owns the per-shape plan cache and the reference's knobs (``width`` W,
    ``min_batch``, ``max_batch``).  ``run`` preserves input order and
    returns ``(answers, epoch)`` per query, exactly like
    :func:`repro_torch.sparql.executor.evaluate_at`: the host fallbacks
    (non-batchable shape, short group, width overflow, host-only snapshot)
    are invisible in the results.  ``stats`` counts queries answered by
    the matcher (``batched``), on the host (``fallback``, and ``overflow``
    of those) and the groups matched.

    The matcher runs on the caller's current stream, after it has waited
    for the snapshot's publication (:meth:`StoreSnapshot.device_views`).
    """

    def __init__(self, width: int = 4096, min_batch: int = 2,
                 max_batch: int = 256):
        self.width = width
        self.min_batch = max(int(min_batch), 1)
        self.max_batch = max(int(max_batch), 1)
        self._plans: dict[tuple, BatchPlan | None] = {}
        self.stats = {"batched": 0, "fallback": 0, "overflow": 0, "groups": 0}

    def _plan(self, sig) -> BatchPlan | None:
        if sig not in self._plans:
            self._plans[sig] = build_plan(sig)
        return self._plans[sig]

    def run(self, queries: list[Query], snapshot, dic) -> list:
        results: list = [None] * len(queries)
        if not queries:
            return results
        if not getattr(snapshot, "on_device", False):
            for i, q in enumerate(queries):
                results[i] = evaluate_at(q, snapshot, dic)
            self.stats["fallback"] += len(queries)
            return results
        rep = snapshot.rho.rep
        prepared: list = [None] * len(queries)
        groups: dict[tuple, list[int]] = {}
        host: list[int] = []
        for i, q in enumerate(queries):
            qn = _normalise_query(q, rep)
            sig, varmap = shape_signature(qn.patterns)
            if self._plan(sig) is None:
                host.append(i)
                continue
            prepared[i] = (qn, varmap)
            groups.setdefault(sig, []).append(i)
        for sig, idxs in list(groups.items()):
            if len(idxs) < self.min_batch:  # batching buys nothing
                host.extend(idxs)
                del groups[sig]
        for i in host:
            results[i] = evaluate_at(queries[i], snapshot, dic)
            self.stats["fallback"] += 1
        for sig, idxs in groups.items():
            for at in range(0, len(idxs), self.max_batch):
                self._run_group(
                    sig, idxs[at:at + self.max_batch], prepared,
                    queries, snapshot, dic, results,
                )
        return results

    def _run_group(self, sig, idxs, prepared, queries, snapshot, dic, results):
        plan = self._plans[sig]
        B, W = len(idxs), self.width
        consts = np.zeros((B, max(plan.n_consts, 1)), np.int32)
        for row, i in enumerate(idxs):
            qn, _ = prepared[i]
            cs = [t for atom in qn.patterns for t in atom if not is_var(t)]
            if cs:
                consts[row] = cs
        views = snapshot.device_views()
        out, valid, overflow = _bgp(
            plan.probes, plan.var_order, W, *views,
            torch.from_numpy(consts).to(views[1].device))
        # the group's one device-to-host copy
        flat = torch.cat([out.view(-1), valid.view(-1).to(I32),
                          overflow.to(I32)]).cpu().numpy()
        n_out = out.numel()
        out = flat[:n_out].reshape(out.shape)
        valid = flat[n_out:n_out + B * W].reshape(B, W).astype(bool)
        overflow = flat[n_out + B * W:].astype(bool)
        col_of = {cv: k for k, cv in enumerate(plan.var_order)}
        for row, i in enumerate(idxs):
            if overflow[row]:
                results[i] = evaluate_at(queries[i], snapshot, dic)
                self.stats["overflow"] += 1
                continue
            qn, varmap = prepared[i]
            sel = np.flatnonzero(valid[row])
            cols = {
                v: out[row, col_of[cv]][sel].astype(np.int32)
                for v, cv in varmap.items()
            }
            sol = _Solutions(Bindings(cols, int(sel.shape[0])))
            results[i] = (
                _finish(queries[i], qn, sol, snapshot.rho, dic),
                snapshot.epoch,
            )
            self.stats["batched"] += 1
        self.stats["groups"] += 1
