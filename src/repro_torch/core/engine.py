"""REW materialisation engine on PyTorch — the port of ``repro.core.engine_jax``.

The single-device paths of the reference's ``JaxEngine``: the paper's
Algorithms 1-6 in bulk, one round at a time.  Each round normalises the
candidate stream with rho, merges new sameAs pairs, sweeps the store, dedups
the stream and inserts the fresh rows, then evaluates the rule plans on the
fresh delta (:func:`eval_plan`).  Two round loops drive it, as in the
reference:

  * the fused loop (``fuse_rounds=True``, the default): every round at the
    stream width is the static-shape body :func:`repro_torch.core.fused.forward_round`
    (:func:`process_static` and every delta plan), whose counts and
    overflow bits stay on the device in one flag vector that the host reads
    once a round; on the card the body is one captured CUDA graph a round,
  * the host loop (``fuse_rounds=False``): :func:`process_candidates` (the
    same state update, with the round's fresh delta), one host read of its
    counts and bits, then the delta plans the fresh rows' resource masks
    allow.

Layout and semantics follow the reference exactly, so that the same state
gives the same arrays in both packages:

  * store = arena ``spo (cap+1, 3) int32`` + ``epoch`` (-1 = free, else the
    insertion round) + ``marked`` (the paper's outdated bit); the last row is
    the trash slot and stays dead,
  * delta discipline via epochs: round r matches Delta = (epoch == r-1),
    T_old = (epoch <= r-2), T_all = (epoch <= r-1),
  * joins sort the binding table (never the arena) and binary-search it;
    atoms whose fixed positions form an (s, p, o) prefix probe the
    persistent sorted index ``sort_perm``/``sorted_keys`` instead,
  * every buffer has a static capacity with an overflow flag; the host
    restarts the run with the exhausted capacity doubled.

:class:`TorchEngine` also maintains a materialised state under updates, as
the reference's engine does (``add_facts``, ``delete_facts``,
``materialise_incremental``; the phases live in
:mod:`repro_torch.core.incremental_spmd`): additions resume the round loop
at the next epoch; deletions tag tombstones (``tomb``, matched by the
PRED_TSTORE/TDELTA predicates of the overdelete plans), split suspect
cliques and rederive through head-bound plans (:func:`build_rederive_plan`);
a rho merge that rewrites a rule constant during an update evaluates one
merge-anchored plan (:func:`classify_remerge`, :func:`build_merge_plan`)
instead of requeuing the whole rule.  Updates emit into narrow delta
buffers and roll back to a snapshot and retry on overflow.

The device work goes through the hand-written kernels
(:mod:`repro_torch.kernels.ops`): the stable dedup order, the sorted-key
search, the rho rewrite and the union-find.  Packed keys are native int64;
the reference's ``enable_x64`` scopes have no counterpart.  Unlike the
reference's pure functions, :func:`process_candidates` writes the fresh rows
into ``spo``/``epoch`` in place (the run owns its arena; a capacity restart
starts from a fresh one), saving an arena copy per round.

**Sharding** (pass ``mesh=``, an :class:`~repro_torch.launch.mesh.EngineMesh`):
the reference's ``mesh=`` path, one process per rank.  Each rank holds its
shard of the arena (a fact lives on shard ``subject % D``), its part of the
index and a full copy of rho, and runs the same host logic; the round
bodies take the mesh and move rows with :mod:`repro_torch.core.collectives`
where the reference's ``shard_map`` bodies do: bindings are gathered
between the atoms of a join, new sameAs pairs are gathered into the
replicated union-find, candidate and sweep rows reach their owner by the
gather-and-own filter or one all-to-all of ``(D, route_cap)`` buckets
(:func:`_route_rows`), and every count and flag the host reads is reduced
over the ranks first, so every rank takes every branch alike.  Under a mesh
a fused round runs eagerly (no CUDA graph).

``TorchEngine.dispatches`` (:class:`~repro_torch.core.stats.DispatchCounter`)
counts every unit of work the reference dispatches as one compiled call, by
the reference's family names, under the maintenance phase the generators
tag.  Each family also registers a trace builder in :data:`AUDIT_REGISTRY`
(:func:`register_auditable`), which :mod:`repro_torch.analysis` runs under
its recorder at a probe geometry.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.merge import merge_sorted

from . import collectives as coll
from . import spans
from .materialise import Contradiction
from .rules import Program, Rule
from .stats import DispatchCounter, MatStats
from .terms import DIFFERENT_FROM, SAME_AS, is_var
from .triples import pack
from .uf import FrozenRho, merge_pairs

I32 = torch.int32
I64 = torch.int64
KEY_MAX = (1 << 63) - 1  # > any packed key (IDs < 2^21 - 1)

# epoch predicates for matching.  PRED_OLD/DELTA/ALL drive the forward
# rounds; PRED_TSTORE/TDELTA the overdelete waves of the incremental delete
# path (repro_torch.core.incremental_spmd): a deleted row is tagged in the
# ``tomb`` column with the wave that retracted it (-1 = live), and wave w
# matches Delta = (tomb == w-1) against the whole pre-deletion store.
PRED_OLD, PRED_DELTA, PRED_ALL = 0, 1, 2
PRED_TSTORE, PRED_TDELTA = 3, 4


class CapacityError(RuntimeError):
    """A static buffer overflowed; the message names the capacity to grow."""


# -- auditable-unit registry (repro_torch.analysis) ---------------------------
#
# Every family of units the engine dispatches registers a *trace builder*:
# ``builder(engine, state)`` yields ``(label, run)`` pairs covering the
# family's variants at the caller's probe geometry, ``run()`` running the
# unit once on inputs the builder made (copies, where the unit writes in
# place).  ``repro_torch.analysis`` records each run and checks its passes
# over the record; ``skip_passes`` names the passes whose invariant the
# family is exempt from by design, as the reference's registry does.

@dataclass(frozen=True)
class AuditableFn:
    name: str
    builder: callable
    skip_passes: tuple = ()


AUDIT_REGISTRY: dict[str, AuditableFn] = {}


def register_auditable(name: str, skip_passes: tuple = ()):
    def deco(builder):
        AUDIT_REGISTRY[name] = AuditableFn(name, builder, tuple(skip_passes))
        return builder

    return deco


def _pack3(spo: torch.Tensor) -> torch.Tensor:
    s = spo[..., 0].to(I64)
    p = spo[..., 1].to(I64)
    o = spo[..., 2].to(I64)
    return (s << 42) | (p << 21) | o


def _pack_cols(cols: list[torch.Tensor]) -> torch.Tensor:
    key = torch.zeros(cols[0].shape, dtype=I64, device=cols[0].device)
    for c in cols:
        key = (key << 21) | c.to(I64)
    return key


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _epoch_ok(epoch, marked, r, pred: int, tomb=None) -> torch.Tensor:
    """Row-selection predicates (``r`` an int or a 0-d tensor).  The
    forward predicates ignore ``tomb`` (the forward rounds run only when
    every tombstone has been finalised into ``marked``); the tombstone
    predicates match the pre-deletion store, so a tombstoned row still
    joins during the backward closure."""
    live = (epoch >= 0) & ~marked
    if pred == PRED_TSTORE:
        return live
    if pred == PRED_TDELTA:
        return live & (tomb == r - 1)
    if pred == PRED_OLD:
        return live & (epoch <= r - 2)
    if pred == PRED_DELTA:
        return live & (epoch == r - 1)
    return live & (epoch <= r - 1)


def _match_atom(spo, ok, consts, const_mask, eq_pairs):
    """const_mask/eq_pairs are static; consts is the atom's (3,) int32 row
    of the device constant table."""
    for pos in range(3):
        if const_mask[pos]:
            ok = ok & (spo[:, pos] == consts[pos])
    for a, b in eq_pairs:
        ok = ok & (spo[:, a] == spo[:, b])
    return ok


def _compact(cols: dict, valid: torch.Tensor, cap: int):
    """Pack valid rows to the front, truncating (or padding) at ``cap``.

    A stable partition without sorting: output slot ``j`` gathers the
    ``(j+1)``-th valid row, found by binary search over the inclusive cumsum
    of ``valid``.  Output rows beyond the valid count hold zeros and must
    stay masked by the returned validity; valid rows past ``cap`` raise the
    overflow flag.
    """
    cum = torch.cumsum(valid, 0)
    n_valid = cum[-1]
    j = torch.arange(cap, device=valid.device)
    src = ops.searchsorted(cum, j + 1, side="left").to(I64)
    src = src.clamp_(0, valid.shape[0] - 1)
    out_valid = j < n_valid
    out_cols = {v: torch.where(out_valid, c[src], 0) for v, c in cols.items()}
    return out_cols, out_valid, n_valid > cap


def _gather_rows(rows: torch.Tensor, valid: torch.Tensor, mesh):
    """Every rank's (N, k) ``rows`` (as int32) and their ``valid``, in rank
    order, in one all-gather (``valid`` rides as a last column)."""
    g = coll.all_gather(torch.cat([rows.to(I32), valid.to(I32)[:, None]], 1),
                        mesh)
    return g[:, :-1].contiguous(), g[:, -1] > 0


def _gather_cols(cols: dict, valid: torch.Tensor, mesh):
    """The reference's ``_gather`` of a binding table (each column, then
    ``valid``) in one all-gather: the ranks' rows in rank order."""
    names = list(cols)
    rows = (torch.stack([cols[v].to(I32) for v in names], dim=1) if names
            else torch.zeros((valid.shape[0], 0), dtype=I32, device=valid.device))
    rows, valid = _gather_rows(rows, valid, mesh)
    return {v: rows[:, i] for i, v in enumerate(names)}, valid


def _route_rows(stream, flags, valid, mesh, route_cap: int | None):
    """Owner-route an (N, 3) triple stream to shard ``subject % D``: the
    reference's ``_route_rows`` (``engine_jax.py:382``), shared by the
    round's insertion and the delete path's waves.  ``flags`` is an
    optional (N, k) int32 side table that rides along.  Returns
    ``(stream', flags', valid', overflow)``:

      * no mesh: the identity;
      * ``route_cap`` None: every rank gathers the whole stream and keeps
        the rows it owns (``valid`` masked);
      * else: each rank sorts its rows by owner (stable; invalid rows
        last), puts the first ``route_cap`` of each owner into that
        owner's bucket and exchanges the ``(D, route_cap, 3 + k + 1)``
        buckets in one all-to-all; rows past ``route_cap`` set
        ``overflow`` (the engine grows ``route_cap``).
    """
    dev = stream.device
    if mesh is None:
        return stream, flags, valid, torch.zeros((), dtype=torch.bool, device=dev)
    D = mesh.world
    if route_cap is None:
        packed = [stream] + ([flags.to(I32)] if flags is not None else [])
        g, valid = _gather_rows(torch.cat(packed, dim=1), valid, mesh)
        stream = g[:, :3]
        flags = g[:, 3:] if flags is not None else None
        own = torch.remainder(stream[:, 0], D) == coll.axis_index(mesh)
        return (stream.contiguous(), flags, valid & own,
                torch.zeros((), dtype=torch.bool, device=dev))
    k = 0 if flags is None else flags.shape[1]
    n = stream.shape[0]
    owner = torch.remainder(stream[:, 0], D).to(I32)
    okey = torch.where(valid, owner, D)
    so, order = torch.sort(okey, stable=True)
    starts = torch.searchsorted(so, torch.arange(D, dtype=so.dtype, device=dev))
    pos = torch.arange(n, device=dev) - starts[so.clamp(0, D - 1).to(I64)]
    real = so < D
    keep = real & (pos < route_cap)
    overflow = (real & (pos >= route_cap)).any()
    cols = [stream[order]]
    if flags is not None:
        cols.append(flags[order].to(I32))
    cols.append(keep[:, None].to(I32))
    payload = torch.cat(cols, dim=1)
    trash = D * route_cap
    buckets = torch.zeros((trash + 1, 3 + k + 1), dtype=I32, device=dev)
    tgt = torch.where(keep, so.to(I64) * route_cap + pos, trash)
    buckets.index_put_((tgt,), torch.where(keep[:, None], payload, 0))
    recv = coll.all_to_all(buckets[:trash], mesh)
    out_flags = recv[:, 3:3 + k] if flags is not None else None
    return recv[:, :3].contiguous(), out_flags, recv[:, 3 + k] > 0, overflow


def _index_remove(sort_perm, sorted_keys, dead, trash: int):
    """Drop rows flagged ``dead`` from the sorted arena index: a stable
    partition of the survivors (cumsum + binary-searched gather); freed tail
    slots revert to the ``trash`` row / KEY_MAX padding."""
    C = sorted_keys.shape[0]
    keep = (sorted_keys < KEY_MAX) & ~dead[sort_perm.to(I64)]
    cum = torch.cumsum(keep, 0)
    j = torch.arange(C, device=keep.device)
    src = ops.searchsorted(cum, j + 1, side="left").to(I64).clamp_(0, C - 1)
    ok = j < cum[-1]
    new_perm = torch.where(ok, sort_perm[src], trash)
    new_keys = torch.where(ok, sorted_keys[src], KEY_MAX)
    return new_perm, new_keys


def _expand_join(cols, valid, spo, ok, bound_items, free_items, out_cap):
    """Join bindings against (spo, ok) on ``bound_items``.

    The binding table is ordered by the dedup kernel — never the arena —
    and every ok store row counts its matching bindings by binary search;
    the output enumerates (store row, binding) pairs store-major.  Invalid
    bindings get KEY_MAX keys and KEY_MAX store keys count nothing.
    """
    if bound_items:
        skey = _pack_cols([spo[:, pos] for _, pos in bound_items])
        bkey = _pack_cols([cols[v] for v, _ in bound_items])
    else:
        skey = torch.zeros(spo.shape[0], dtype=I64, device=spo.device)
        bkey = torch.zeros(valid.shape[0], dtype=I64, device=spo.device)
    bkey = torch.where(valid, bkey, KEY_MAX)
    spans.count_sorted(valid)
    border = ops.dedup_order(bkey).to(I64)
    bkey_s = bkey[border]
    lo, hi = ops.search_bounds(skey, bkey_s)
    counts = torch.where(ok & (skey != KEY_MAX), hi - lo, 0).to(I64)
    cum = torch.cumsum(counts, 0) - counts  # exclusive
    total = counts.sum()
    j = torch.arange(out_cap, device=spo.device)
    seg = ops.searchsorted(cum, j, side="right").to(I64) - 1
    seg = seg.clamp_(0, spo.shape[0] - 1)
    within = j - cum[seg]
    brow = border[(lo.to(I64)[seg] + within).clamp_(0, valid.shape[0] - 1)]
    out_valid = j < total
    new_cols = {v: torch.where(out_valid, cols[v][brow], 0) for v in cols}
    for v, pos in free_items:
        new_cols[v] = torch.where(out_valid, spo[seg, pos], 0)
    return new_cols, out_valid, total > out_cap


@dataclass(frozen=True)
class _AtomSpec:
    """Static structure of one body atom within a plan."""

    index: int
    const_mask: tuple[bool, bool, bool]
    eq_pairs: tuple[tuple[int, int], ...]
    bound_items: tuple[tuple[int, int], ...]
    free_items: tuple[tuple[int, int], ...]
    pred: int
    count_appl: bool = False  # this atom feeds the 'Rule appl.' counter


def _index_prefix(spec: _AtomSpec):
    """Can this atom's join run as persistent-index range scans?

    True when the atom's fixed positions (constants and already-bound
    variables, equality duplicates included) form a prefix of (s, p, o).
    Returns ``(k, components)`` with ``k`` the prefix length and
    ``components`` the per-position value source (``("const", pos)`` or
    ``("var", var_id)``), or ``(None, None)`` for the generic join.
    """
    pos_src: dict[int, tuple] = {}
    for v, p in spec.bound_items:
        pos_src[p] = ("bound", v)
    for v, p in spec.free_items:
        pos_src[p] = ("free", v)
    for a, b in spec.eq_pairs:
        if a in pos_src:
            pos_src[b] = pos_src[a]
    fixed = [
        spec.const_mask[p] or pos_src.get(p, ("free",))[0] == "bound"
        for p in range(3)
    ]
    k = 0
    while k < 3 and fixed[k]:
        k += 1
    if k == 0 or any(fixed[k:]):
        return None, None
    comp = []
    for p in range(k):
        if spec.const_mask[p]:
            comp.append(("const", p))
        else:
            comp.append(("var", pos_src[p][1]))
    return k, tuple(comp)


def _atom_static(atom, bound_vars: set[int]):
    const_mask = tuple(not is_var(t) for t in atom)
    eq_pairs = []
    first_pos: dict[int, int] = {}
    for pos, t in enumerate(atom):
        if is_var(t):
            if t in first_pos:
                eq_pairs.append((first_pos[t], pos))
            else:
                first_pos[t] = pos
    bound = tuple((v, p) for v, p in first_pos.items() if v in bound_vars)
    free = tuple((v, p) for v, p in first_pos.items() if v not in bound_vars)
    return const_mask, tuple(eq_pairs), bound, free


def build_plans(rule: Rule, full: bool,
                tombstone: bool = False) -> list[list[_AtomSpec]]:
    """Delta plans (or the single full-evaluation plan) of a rule.

    ``tombstone=True`` builds the overdelete variants: the delta atom
    matches the last overdelete wave (PRED_TDELTA), every other atom the
    whole pre-deletion store (PRED_TSTORE); they count nothing."""
    if full and tombstone:
        raise ValueError("a tombstone plan is a delta plan")
    plans = []
    delta_positions = [0] if full else list(range(len(rule.body)))
    for i in delta_positions:
        specs = []
        bound: set[int] = set()
        for j, atom in enumerate(rule.body):
            const_mask, eq_pairs, b, f = _atom_static(atom, bound)
            if full:
                pred = PRED_ALL
            else:
                pred = PRED_OLD if j < i else (PRED_DELTA if j == i else PRED_ALL)
            if tombstone:
                pred = PRED_TDELTA if pred == PRED_DELTA else PRED_TSTORE
            count_appl = not tombstone and (
                (pred == PRED_DELTA) or (full and j == 0))
            specs.append(_AtomSpec(j, const_mask, eq_pairs, b, f, pred, count_appl))
            bound |= {v for v, _ in b} | {v for v, _ in f}
        plans.append(specs)
    return plans


def _expand_join_index(cols, valid, spo, epoch, marked, r, sorted_keys,
                       sort_perm, consts, spec: _AtomSpec, k: int, comp: tuple,
                       out_cap: int, tomb=None):
    """Index-backed variant of :func:`_expand_join` for prefix-key atoms.

    Each binding's matches in the live store are one contiguous range of the
    persistent sorted index, found by the prefix form of the search kernel;
    the output enumerates (binding, index entry) pairs and a post-filter
    applies the epoch predicate and intra-atom equalities.
    """
    parts = []
    for src, ref in comp:
        if src == "const":
            parts.append(consts[ref].expand(valid.shape))
        else:
            parts.append(cols[ref].to(I32))
    prefix = torch.stack(parts, dim=1).contiguous()
    lo, hi = ops.prefix_range_bounds(prefix, sorted_keys)
    counts = torch.where(valid, (hi - lo).clamp_(min=0), 0).to(I64)
    cum = torch.cumsum(counts, 0) - counts  # exclusive
    total = counts.sum()
    j = torch.arange(out_cap, device=spo.device)
    seg = ops.searchsorted(cum, j, side="right").to(I64) - 1
    seg = seg.clamp_(0, valid.shape[0] - 1)
    within = j - cum[seg]
    pos = (lo.to(I64)[seg] + within).clamp_(0, sort_perm.shape[0] - 1)
    srow = sort_perm[pos].to(I64)
    out_valid = j < total
    rows = spo[srow]
    okr = _epoch_ok(epoch[srow], marked[srow], r, spec.pred,
                    None if tomb is None else tomb[srow])
    okr = _match_atom(rows, okr, consts, spec.const_mask, spec.eq_pairs)
    out_valid = out_valid & okr
    new_cols = {v: torch.where(out_valid, cols[v][seg], 0) for v in cols}
    for v, p in spec.free_items:
        new_cols[v] = torch.where(out_valid, rows[:, p], 0)
    return new_cols, out_valid, total > out_cap


def _join_step(cols, valid, spo, epoch, marked, r, sorted_keys, sort_perm,
               consts, spec: _AtomSpec, bind_cap: int, tomb=None):
    """One join step of :func:`eval_plan` and :func:`eval_plan_rederive`:
    prefix-key atoms whose predicate admits every live row (PRED_ALL,
    PRED_TSTORE) run as index range scans, the rest as the generic
    binding-sorting join.  Returns ``(cols, valid, overflow)``."""
    if spec.pred in (PRED_ALL, PRED_TSTORE):
        k, comp = _index_prefix(spec)
        if k is not None:
            return _expand_join_index(
                cols, valid, spo, epoch, marked, r, sorted_keys, sort_perm,
                consts, spec, k, comp, bind_cap, tomb,
            )
    ok = _epoch_ok(epoch, marked, r, spec.pred, tomb)
    ok = _match_atom(spo, ok, consts, spec.const_mask, spec.eq_pairs)
    return _expand_join(cols, valid, spo, ok, spec.bound_items,
                        spec.free_items, bind_cap)


def _emit_heads(cols, valid, head_consts, head_var_slots: tuple, out_cap: int):
    """Instantiate the head pattern over a binding table and compact it to
    the output buffer; returns ``(out, out_valid, n_deriv, overflow)``."""
    heads = []
    for pos in range(3):
        v = head_var_slots[pos]
        if v is None:
            heads.append(head_consts[pos].expand(valid.shape))
        else:
            heads.append(cols[v].to(I32))
    outc, out_valid, ov = _compact(
        {"s": heads[0], "p": heads[1], "o": heads[2]}, valid, out_cap
    )
    out = torch.stack([outc["s"], outc["p"], outc["o"]], dim=1)
    return out, out_valid, out_valid.sum(), ov


def eval_plan(spo, epoch, marked, sorted_keys, sort_perm, r, atom_consts,
              head_consts, plan: tuple, head_var_slots: tuple, bind_cap: int,
              out_cap: int, tomb=None, mesh=None):
    """Evaluate one plan at round ``r`` (an int or a 0-d tensor; a
    tombstone plan's wave).  ``tomb`` is the tombstone column the
    tombstone predicates read.

    With a ``mesh`` each atom joins against the rank's shard and the
    binding table is gathered between atoms, so every rank joins the whole
    table; the final join's rows stay on their rank (their union over the
    ranks is the plan's output) and the counts are the rank's own.

    ``atom_consts`` (n_atoms, 3) holds each body atom's IDs (variables'
    entries are ignored) and ``head_consts`` (3,) the head's: int32 tensors
    on the store's device (the rows of :func:`repro_torch.core.fused.program_tables`),
    or nested sequences, which are copied there.  Returns ``(heads
    (out_cap, 3), valid, n_deriv, n_appl, bind_overflow, out_overflow)``,
    the last four as 0-d tensors.
    """
    dev = spo.device
    atom_consts = torch.as_tensor(atom_consts, dtype=I32, device=dev)
    head_consts = torch.as_tensor(head_consts, dtype=I32, device=dev)
    cols: dict[int, torch.Tensor] = {}
    valid = torch.ones(1, dtype=torch.bool, device=dev)  # the unit binding
    n_appl = torch.zeros((), dtype=I64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for step, spec in enumerate(plan):
        consts = atom_consts[spec.index]
        is_join = not (step == 0 and not spec.bound_items)
        if spec.count_appl or not is_join:
            ok = _epoch_ok(epoch, marked, r, spec.pred, tomb)
            ok = _match_atom(spo, ok, consts, spec.const_mask, spec.eq_pairs)
            if spec.count_appl:
                n_appl = n_appl + ok.sum()
        if not is_join:
            # initial scan: bindings = matching rows directly (no join needed)
            cols = {v: torch.where(ok, spo[:, p], 0) for v, p in spec.free_items}
            cols, valid, ov = _compact(cols, ok, bind_cap)
        else:
            cols, valid, ov = _join_step(
                cols, valid, spo, epoch, marked, r, sorted_keys, sort_perm,
                consts, spec, bind_cap, tomb,
            )
        overflow = overflow | ov
        if mesh is not None and step < len(plan) - 1:
            cols, valid = _gather_cols(cols, valid, mesh)
    out, out_valid, n_deriv, ov = _emit_heads(
        cols, valid, head_consts, head_var_slots, out_cap
    )
    return out, out_valid, n_deriv, n_appl, overflow, ov


def _chain(rule: Rule, remaining: list[int], bound: set[int],
           pred: int) -> list[_AtomSpec]:
    """Specs of the ``remaining`` body atoms at ``pred``, ordered greedily:
    next the first atom sharing a variable with the ``bound`` set, else the
    first left."""
    specs: list[_AtomSpec] = []
    while remaining:
        j = next((i for i in remaining
                  if any(is_var(t) and t in bound for t in rule.body[i])),
                 remaining[0])
        remaining.remove(j)
        const_mask, eq_pairs, b, f = _atom_static(rule.body[j], bound)
        specs.append(_AtomSpec(j, const_mask, eq_pairs, b, f, pred))
        bound |= {v for v, _ in b} | {v for v, _ in f}
    return specs


def build_rederive_plan(rule: Rule) -> tuple[list[_AtomSpec], tuple[int, ...]]:
    """The single head-bound plan of a rule for targeted rederivation.

    The head variables are pre-bound to the overdeleted instances and every
    body atom matches the surviving live store (PRED_TSTORE); atoms are
    ordered greedily so each step shares a variable with the bound set
    where it can, so bound positions form index prefixes.  Returns
    ``(specs, head_vars)``, ``head_vars`` the head's first-occurrence
    variable order: the seed table's column order.
    """
    head_vars = tuple(dict.fromkeys(t for t in rule.head if is_var(t)))
    return _chain(rule, list(range(len(rule.body))), set(head_vars),
                  PRED_TSTORE), head_vars


def eval_plan_rederive(spo, epoch, marked, sorted_keys, sort_perm, atom_consts,
                       head_consts, seeds, seed_valid, plan: tuple,
                       head_var_slots: tuple, seed_vars: tuple, bind_cap: int,
                       out_cap: int, tomb=None, mesh=None):
    """Head-bound rederivation join: the binding table starts from the seed
    columns ((m, len(seed_vars)) int32, one per head variable) instead of a
    store scan, so every join scales with the overdelete delta.  Returns
    ``(heads, valid, n_deriv, bind_overflow, out_overflow)``.  With a
    ``mesh`` the seeds are every rank's and the bindings are gathered
    between atoms, as in :func:`eval_plan`."""
    dev = spo.device
    atom_consts = torch.as_tensor(atom_consts, dtype=I32, device=dev)
    head_consts = torch.as_tensor(head_consts, dtype=I32, device=dev)
    cols = {v: seeds[:, i].to(I32) for i, v in enumerate(seed_vars)}
    valid = seed_valid
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for step, spec in enumerate(plan):  # PRED_TSTORE ignores the round
        cols, valid, ov = _join_step(
            cols, valid, spo, epoch, marked, 0, sorted_keys, sort_perm,
            atom_consts[spec.index], spec, bind_cap, tomb,
        )
        overflow = overflow | ov
        if mesh is not None and step < len(plan) - 1:
            cols, valid = _gather_cols(cols, valid, mesh)
    out, out_valid, n_deriv, ov_out = _emit_heads(
        cols, valid, head_consts, head_var_slots, out_cap
    )
    return out, out_valid, n_deriv, overflow, ov_out


def classify_remerge(rule_old: Rule, rule_new: Rule):
    """How to re-evaluate a rule whose constants a rho merge rewrote:
    ``("skip", None)`` when only the head changed (the sweep re-normalises
    the stored heads), ``("anchor", j)`` for the merge-targeted plan of
    :func:`build_merge_plan` anchored at changed body atom ``j`` (among
    changed atoms with a variable, the one sharing most variables with the
    rest of the body, ties to the earliest), or ``("full", None)`` when
    every changed body atom is ground (whole-rule requeue)."""
    changed = [j for j, (a, b) in enumerate(zip(rule_old.body, rule_new.body))
               if a != b]
    if not changed:
        return "skip", None
    scored = []
    for j in changed:
        vs = {t for t in rule_new.body[j] if is_var(t)}
        if not vs:
            continue
        rest = {t for i, atom in enumerate(rule_new.body) if i != j
                for t in atom if is_var(t)}
        scored.append((len(vs & rest), -j))
    if not scored:
        return "full", None
    _, neg_j = max(scored)
    return "anchor", -neg_j


def build_merge_plan(rule: Rule, anchor: int) -> list[_AtomSpec]:
    """The single merge-targeted plan of a rule a rho merge rewrote: the
    changed ``anchor`` atom scans the pre-merge store (PRED_OLD; it feeds
    'Rule appl.'), the other atoms chain through the live store (PRED_ALL),
    ordered bound-first.  Matches that use a row of the merge round's fresh
    delta are the ordinary delta plans' work."""
    const_mask, eq_pairs, b, f = _atom_static(rule.body[anchor], set())
    first = _AtomSpec(anchor, const_mask, eq_pairs, b, f, PRED_OLD, True)
    rest = [j for j in range(len(rule.body)) if j != anchor]
    return [first] + _chain(rule, rest, {v for v, _ in b + f}, PRED_ALL)


def _squeeze_stream(cands, valid, target: int):
    """Compact a bucketed candidate stream to ``target`` rows (+ overflow)."""
    cols, v, ov = _compact(
        {"s": cands[:, 0], "p": cands[:, 1], "o": cands[:, 2]}, valid, target,
    )
    return torch.stack([cols["s"], cols["p"], cols["o"]], dim=1), v, ov


def _merge_round(rep, cands, cand_valid, mesh=None, route_cap=None,
                 pair_cap: int = 4096):
    """Steps 1-3 of a round: normalise the candidates with rho, merge their
    sameAs pairs (one union and one compression) and normalise again under
    the merged rho.  Returns ``(rep', cands', n_pairs, pair_overflow)``,
    ``n_pairs`` the pairs among this rank's own candidates.

    With a mesh every rank merges the same pairs into its copy of rho
    (min-hooking is order-free, so the copies stay equal): the gathered
    stream's when candidates are gathered, else each rank's pairs
    compacted to ``pair_cap`` rows and gathered (a rank with more sets
    ``pair_overflow``; the engine grows ``pair_cap``)."""
    cands, _ = ops.rewrite_triples(cands, rep, valid=cand_valid)
    is_pair = cand_valid & (cands[:, 1] == SAME_AS) & (cands[:, 0] != cands[:, 2])
    if mesh is not None and route_cap is not None:
        pc, pvalid, p_ov = _compact({"a": cands[:, 0], "b": cands[:, 2]},
                                    is_pair, pair_cap)
        pairs, pvalid = _gather_rows(torch.stack([pc["a"], pc["b"]], dim=1),
                                     pvalid, mesh)
        rep = merge_pairs(rep, pairs, pvalid)
        n_pairs = is_pair.sum()
    else:
        pairs = torch.stack([cands[:, 0], cands[:, 2]], dim=1)
        rep = merge_pairs(rep, pairs, is_pair)
        p_ov = torch.zeros((), dtype=torch.bool, device=cands.device)
        if mesh is None:
            n_pairs = is_pair.sum()
        else:  # the gathered stream: count this rank's block
            n_pairs = is_pair.view(mesh.world, -1)[coll.axis_index(mesh)].sum()
    cands, _ = ops.rewrite_triples(cands, rep, valid=cand_valid)
    return rep, cands, n_pairs, p_ov


def _round_stream(all_c, all_v):
    """Step 5-6 of a round: the contradiction check (~=5) on the
    normalised candidates and swept rows, and the stream to insert: those
    rows, their reflexive expansion (Algorithm 4 lines 17-18: <c, sameAs,
    c> for each resource of each row) and <sameAs, sameAs, sameAs>.
    Returns ``(stream, stream_valid, contradiction)``; the expansion's rows
    are those from ``all_c.shape[0]`` on."""
    dev = all_c.device
    contradiction = (
        all_v & (all_c[:, 1] == DIFFERENT_FROM) & (all_c[:, 0] == all_c[:, 2])
    ).any()
    res = all_c.reshape(-1)
    res_valid = all_v[:, None].expand(-1, 3).reshape(-1)
    refl = torch.stack([res, torch.full_like(res, SAME_AS), res], dim=1)
    sa_row = torch.full((1, 3), SAME_AS, dtype=I32, device=dev)
    stream = torch.cat([all_c, refl, sa_row], dim=0)
    stream_v = torch.cat([all_v, res_valid, all_v.any().reshape(1)], dim=0)
    return stream, stream_v, contradiction


def _fresh_rows(stream, stream_v, is_refl_row, sorted_keys):
    """Steps 7-8 of a round: the stable dedup order of the stream and its
    membership against the live rows through the persistent index.

    ``is_refl_row`` says which stream rows the reflexive expansion made:
    an int (the rows from it on) or a bool column.  Returns ``(order, sk,
    fresh, is_refl)``: the stream's stable key order and the sorted keys,
    which sorted positions hold a fresh fact, and which of those the
    reflexive expansion made (the stable order keeps a candidate
    occurrence of the same fact ahead of them).  No host read."""
    C = sorted_keys.shape[0]
    skeys = torch.where(stream_v, _pack3(stream), KEY_MAX)
    spans.count_sorted(stream_v)
    order = ops.dedup_order(skeys).to(I64)
    sk = skeys[order]
    uniq = torch.ones_like(stream_v)
    uniq[1:] = sk[1:] != sk[:-1]
    uniq &= sk < KEY_MAX
    pos = ops.searchsorted(sorted_keys, sk, side="left").to(I64).clamp_(0, C - 1)
    fresh = uniq & (sorted_keys[pos] != sk)
    if isinstance(is_refl_row, int):
        is_refl = fresh & (order >= is_refl_row)
    else:
        is_refl = fresh & is_refl_row[order]
    return order, sk, fresh, is_refl


def _stream_rows(width: int, rewrite_cap: int, mesh=None,
                route_cap: int | None = None) -> int:
    """Rows of a round's dedup stream on one rank: the candidates and the
    swept rows (every rank's, when gathered), their reflexive expansion
    and the sameAs row; or the routed buckets."""
    if mesh is not None and route_cap is not None:
        return mesh.world * route_cap
    D = 1 if mesh is None else mesh.world
    return 4 * D * (width + rewrite_cap) + 1


def process_candidates(spo, epoch, marked, n_used, rep, sort_perm, sorted_keys,
                       cands, cand_valid, r, rewrite_cap: int,
                       delta_window: int = 4096, mesh=None,
                       route_cap: int | None = None, pair_cap: int = 4096):
    """Normalise, merge equalities, sweep, insert — the state-update half of
    a host-loop round (Algorithms 3-6 in bulk), with no host read, as the
    reference's ``process_candidates``.

    :func:`process_static`, plus what the host loop reads after it, all on
    the device: ``flags`` also holds ``rep_changed``, ``n_marked`` (the rows
    the sweep marked) and the round's fresh delta, ``delta_rows``
    (``min(stream rows, delta_window)``, 3) with ``delta_valid``: the first
    fresh rows in key order, which :func:`process_static` wrote to the arena
    rows from the old ``n_used`` on.  The host derives the next round's
    plan-skipping masks from them; a round that inserts more than the
    window falls back to all-True masks.  ``spo`` and ``epoch`` are updated
    in place; on a store overflow the arena holds garbage and the caller
    restarts the run (or rolls the update back).  The flags are the rank's
    own under a mesh (the host reduces them).
    """
    arena_cap = spo.shape[0] - 1
    used = n_used.reshape(()).to(I64)
    (spo, epoch, new_marked, n_used, new_rep, sort_perm, sorted_keys,
     flags) = process_static(spo, epoch, marked, n_used, rep, sort_perm,
                             sorted_keys, cands, cand_valid, r, rewrite_cap,
                             mesh=mesh, route_cap=route_cap, pair_cap=pair_cap)
    spans.stage("rew.flags", spo.device)
    window = min(_stream_rows(cands.shape[0], rewrite_cap, mesh, route_cap),
                 delta_window)
    j = torch.arange(window, device=spo.device)
    delta_valid = j < flags["n_new"]
    rows = spo[(used + j).clamp_(max=arena_cap)]
    flags.update(
        rep_changed=(new_rep != rep).any(),
        n_marked=(new_marked & ~marked).sum(),
        delta_rows=torch.where(delta_valid[:, None], rows, 0),
        delta_valid=delta_valid,
    )
    spans.stage_end(spo.device)
    return spo, epoch, new_marked, n_used, new_rep, sort_perm, sorted_keys, flags


def process_static(spo, epoch, marked, n_used, rep, sort_perm, sorted_keys,
                   cands, cand_valid, r, rewrite_cap: int, mesh=None,
                   route_cap: int | None = None, pair_cap: int = 4096):
    """The state update of one round at static shapes, with no host read:
    the body of a fused round (the reference's ``process_candidates``,
    which the fused ``lax.while_loop`` inlines) and of
    :func:`process_candidates`.

    ``r`` is an int or a 0-d int32 tensor.  Every shape depends on the
    capacities alone and nothing waits on the device, so the same calls can
    be captured once into a CUDA graph and replayed round after round:

      * the store sweep runs every round (a graph has no branch to skip
        it): the rewritten rows compact to ``rewrite_cap`` and leave the
        persistent index whether any row changed or not,
      * the fresh rows compact, in key order, to ``min(stream, C)`` rows
        (C = the index length, so a run that has not overflowed loses
        none) and KEY_MAX-pad the merge into the index,
      * the insertion writes arena rows ``[n_used, n_used + n_fresh)`` as a
        gather over the arena, not as a scatter of the stream with a trash
        slot: the same rows, and the stream's padding makes no writes,
      * every count and overflow bit is a 0-d tensor of ``flags``.

    With a ``mesh`` (the reference's ``shard_map`` body): without
    ``route_cap`` the candidates and the swept rows are gathered, so every
    rank sees the global stream and inserts the rows it owns; with it each
    rank expands its own rows and routes them to their owners
    (:func:`_route_rows`), and only the sameAs pairs are gathered.  The
    counts are the rank's own and the bits its local ones (rho and the
    gathered stream's contradiction are the same on every rank); the
    caller reduces them.

    With the spans on, steps 1-3, 4 and 5-9 are the stages ``rew.merge``,
    ``rew.sweep`` and ``rew.dedup`` (:func:`repro_torch.core.spans.stage`);
    the caller marks the rest of its body and its end.

    ``epoch`` is updated in place and ``spo`` too; the rest comes back
    new.  Returns ``(spo, epoch, marked, n_used, rep, sort_perm,
    sorted_keys, flags)`` with ``flags`` the tensors ``contradiction``,
    ``ov_rewrite``, ``ov_store``, ``ov_route``, ``ov_pair``, ``n_new``,
    ``n_pairs`` and ``n_reflexive``.  On a store overflow the arena holds
    garbage: the caller restarts the run.
    """
    dev = spo.device
    arena_cap = spo.shape[0] - 1  # last row is the trash slot
    C = sorted_keys.shape[0]
    routed = mesh is not None and route_cap is not None
    if mesh is not None and not routed:
        cands, cand_valid = _gather_rows(cands, cand_valid, mesh)

    # 1)-3) normalise, merge sameAs pairs, re-normalise under the new rho
    spans.stage("rew.merge", dev)
    rep, cands, n_pairs, ov_pair = _merge_round(rep, cands, cand_valid, mesh,
                                                route_cap, pair_cap)

    # 4) sweep the store, every round
    spans.stage("rew.sweep", dev)
    rewritten, changed = ops.rewrite_triples(spo, rep, epoch=epoch, marked=marked)
    marked = marked | changed
    rw_cols, rw_valid, rw_overflow = _compact(
        {"s": rewritten[:, 0], "p": rewritten[:, 1], "o": rewritten[:, 2]},
        changed, rewrite_cap,
    )
    rw = torch.stack([rw_cols["s"], rw_cols["p"], rw_cols["o"]], dim=1)
    sort_perm, sorted_keys = _index_remove(sort_perm, sorted_keys, changed,
                                           arena_cap)
    if mesh is not None and not routed:
        rw, rw_valid = _gather_rows(rw, rw_valid, mesh)
    all_c = torch.cat([cands, rw], dim=0)
    all_v = torch.cat([cand_valid, rw_valid], dim=0)

    # 5)-6) contradiction check, reflexivity; the rows each rank inserts
    spans.stage("rew.dedup", dev)
    stream, stream_v, contradiction = _round_stream(all_c, all_v)
    is_refl_row = all_c.shape[0]
    ov_route = torch.zeros((), dtype=torch.bool, device=dev)
    if routed:
        refl_col = (torch.arange(stream.shape[0], device=dev)
                    >= all_c.shape[0]).to(I32)[:, None]
        stream, refl_col, stream_v, ov_route = _route_rows(
            stream, refl_col, stream_v, mesh, route_cap)
        is_refl_row = refl_col[:, 0] > 0
    elif mesh is not None:
        own = torch.remainder(stream[:, 0], mesh.world) == coll.axis_index(mesh)
        stream_v = stream_v & own

    # 7)-8) dedup, membership
    order, sk, fresh, is_refl = _fresh_rows(stream, stream_v, is_refl_row,
                                            sorted_keys)
    n_fresh = fresh.sum()
    n_refl = is_refl.sum()
    used = n_used.reshape(()).to(I64)
    insert_overflow = used + n_fresh > arena_cap

    # 9) the fresh rows, in key order, into arena rows [n_used, n_used +
    # n_fresh), and rank-merged into the persistent index
    width = min(sk.shape[0], C)
    d, d_valid, _ = _compact({"k": sk, "row": order}, fresh, width)
    i = torch.arange(arena_cap + 1, device=dev)
    j = i - used
    put = (j >= 0) & (j < n_fresh) & (i < arena_cap)
    rows = stream[d["row"][j.clamp(0, width - 1)]]
    spo.copy_(torch.where(put[:, None], rows, spo))
    epoch.copy_(torch.where(put, r, epoch))
    d_keys = torch.where(d_valid, d["k"], KEY_MAX)
    d_slots = torch.where(d_valid, used + torch.arange(width, device=dev),
                          arena_cap).to(I32)
    sorted_keys, sort_perm = merge_sorted(sorted_keys, sort_perm, d_keys,
                                          d_slots, out_len=C)
    n_used = (used + n_fresh).to(I32).reshape(1)

    flags = {
        "contradiction": contradiction,
        "ov_rewrite": rw_overflow,
        "ov_store": insert_overflow,
        "ov_route": ov_route,
        "ov_pair": ov_pair,
        "n_new": n_fresh,
        "n_pairs": n_pairs,
        "n_reflexive": n_refl,
    }
    return spo, epoch, marked, n_used, rep, sort_perm, sorted_keys, flags


def index_invariant_report(state: "EngineState", n_shards: int = 1) -> list[str]:
    """Violations of the persistent-index invariant (empty == healthy).

    Per shard block: ``sorted_keys`` must hold exactly the packed keys of
    the live rows, ascending, followed by KEY_MAX padding, and
    ``sort_perm``'s prefix must enumerate exactly those rows.  ``state``
    holds the arrays of all ``n_shards`` shards, concatenated in shard
    order (:meth:`TorchEngine.gathered_state` under a mesh).  A state whose
    index awaits its rebuild is reported as such.
    """
    if state.index_dirty:
        return ["index_dirty: rebuild pending"]
    probs: list[str] = []
    spo = state.spo.cpu().numpy().reshape(n_shards, -1, 3)
    live = ((state.epoch.cpu().numpy() >= 0)
            & ~state.marked.cpu().numpy()).reshape(n_shards, -1)
    keys = state.sorted_keys.cpu().numpy().reshape(n_shards, -1)
    perm = state.sort_perm.cpu().numpy().reshape(n_shards, -1)
    for s in range(n_shards):
        tag = f"shard {s}: " if n_shards > 1 else ""
        want = np.sort(pack(spo[s][live[s]]))
        n = want.shape[0]
        if not (keys[s][n:] == KEY_MAX).all():
            probs.append(tag + "non-sentinel entries beyond live prefix")
        if not np.array_equal(keys[s][:n], want):
            probs.append(tag + "sorted_keys != sort(pack3(live rows))")
        if not np.array_equal(np.sort(perm[s][:n]), np.flatnonzero(live[s])):
            probs.append(tag + "sort_perm prefix is not the live row set")
        if not np.array_equal(pack(spo[s][perm[s][:n]]), keys[s][:n]):
            probs.append(tag + "sort_perm rows disagree with sorted_keys")
    return probs


_STATE_ARRAYS = {
    "spo": I32, "epoch": I32, "marked": torch.bool, "tomb": I32,
    "n_used": I32, "rep": I32, "sort_perm": I32, "sorted_keys": I64,
}


def _unpack3(keys: torch.Tensor) -> torch.Tensor:
    """(n,) packed int64 keys -> (n, 3) int32 rows."""
    m = (1 << 21) - 1
    return torch.stack([(keys >> 42) & m, (keys >> 21) & m, keys & m],
                       dim=1).to(I32)


def _rebuild_index(spo, epoch, marked):
    """Full rebuild of the sorted arena index (the stable order of the live
    rows' keys, KEY_MAX behind): the one arena sort, paid at most once per
    capacity growth of the store."""
    live = (epoch >= 0) & ~marked
    keys = torch.where(live, _pack3(spo), KEY_MAX)
    spans.count_sorted(live)
    perm = ops.dedup_order(keys)
    return perm, keys[perm.to(I64)]


@dataclass
class EngineState:
    """Materialisation state on one device, maintained across updates.

    ``sort_perm``/``sorted_keys`` is the persistent sorted arena index: the
    packed int64 keys of exactly the live (``epoch >= 0 & ~marked``) rows in
    ascending order, KEY_MAX padding behind, and each entry's arena row;
    ``index_dirty`` marks it stale after the arena grew (the next update
    rebuilds it).  ``tomb`` is the delete path's tombstone column (-1 =
    live, else the overdelete wave that tagged the row; all -1 between
    operations).  ``r`` is the running round counter: epochs keep growing
    across updates, so the delta discipline carries over.  ``explicit`` is
    the explicit fact set as sorted distinct packed keys on the device
    (:meth:`TorchEngine.explicit_rows` unpacks it); ``base_program`` the
    program as given, ``program`` its rewriting under rho;
    ``update_epoch`` counts the completed updates.
    """

    spo: torch.Tensor
    epoch: torch.Tensor
    marked: torch.Tensor
    tomb: torch.Tensor
    n_used: torch.Tensor
    rep: torch.Tensor
    sort_perm: torch.Tensor
    sorted_keys: torch.Tensor
    program: Program
    r: int
    stats: MatStats
    base_program: Program | None = None
    explicit: torch.Tensor | None = None
    update_epoch: int = 0
    index_dirty: bool = False

    def __post_init__(self) -> None:
        if self.base_program is None:
            self.base_program = self.program
        if self.explicit is None:
            self.explicit = torch.zeros(0, dtype=I64, device=self.spo.device)

    @property
    def n_res(self) -> int:
        return int(self.rep.shape[0])


class StoreSnapshot:
    """Immutable, epoch-consistent read view of an :class:`EngineState`.

    Published at epoch barriers only, after a maintenance operation's
    fixpoint, so a query evaluated against it observes exactly the fixpoint
    of maintenance epoch ``epoch``; ``rho`` is the frozen representative
    view whose clique tables every query of the epoch shares (the serving
    contract of :mod:`repro_torch.serve.triple_store`).

    Two backing forms, as the reference's:

      * **host**: ``triples`` is an eager host copy of the live normal-form
        store (:meth:`TorchEngine.read_snapshot`);
      * **device-resident** (:meth:`TorchEngine.publish_snapshot`): the
        live rows stay on the device in two sorted orders, ``(s,p,o)``
        packed-key order (``d_triples``/``d_keys``) and ``(p,o,s)`` order
        (``d_triples_pos``/``d_keys_pos``), each padded to the arena
        length with KEY_MAX keys behind the ``n_live`` live rows, which the
        batched matcher (:mod:`repro_torch.sparql.batched`) range-probes;
        ``triples`` is copied to the host on first use.

    The device tensors are made at publication, never views of the state:
    the engine writes its arena and index in place, so a view would change
    under its readers at the next update.  On the card ``ready`` is an
    event recorded after the publication's last write, on the stream that
    published; :meth:`device_views` orders a reader's stream after it.
    """

    __slots__ = (
        "epoch", "rho", "_triples", "n_live",
        "d_triples", "d_keys", "d_triples_pos", "d_keys_pos",
        "ready", "_streams",
    )

    def __init__(self, epoch: int, rho: FrozenRho,
                 triples: np.ndarray | None = None, device: tuple | None = None,
                 ready: "torch.cuda.Event | None" = None) -> None:
        self.epoch = epoch
        self.rho = rho
        self._triples = triples
        self.ready = ready
        self._streams: set[int] = set()
        if device is not None:
            (self.d_triples, self.d_keys, self.d_triples_pos,
             self.d_keys_pos, self.n_live) = device
        else:
            self.d_triples = self.d_keys = None
            self.d_triples_pos = self.d_keys_pos = None
            self.n_live = None if triples is None else int(triples.shape[0])

    @property
    def on_device(self) -> bool:
        return self.d_keys is not None

    def device_views(self) -> tuple:
        """``(d_triples, d_keys, d_triples_pos, d_keys_pos)``, safe to read
        on the caller's current stream: the first time a stream asks, it
        waits for the publication's event, and the allocator learns that
        the stream reads the tensors (a retired snapshot's memory is not
        reused while that stream may still read it)."""
        views = (self.d_triples, self.d_keys, self.d_triples_pos, self.d_keys_pos)
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.d_keys.device)
            if stream.cuda_stream not in self._streams:
                stream.wait_event(self.ready)
                for t in views:
                    t.record_stream(stream)
                self._streams.add(stream.cuda_stream)
        return views

    @property
    def triples(self) -> np.ndarray:
        """Host copy of the normal-form store (lazy for device snapshots)."""
        if self._triples is None:
            d_triples = self.device_views()[0]
            t = d_triples[: self.n_live].cpu().numpy()
            t.setflags(write=False)
            self._triples = t
        return self._triples

    @property
    def n_res(self) -> int:
        return len(self.rho)


class _StageClock:
    """Stage times of one publication in ms: CUDA events on the card
    (device time between marks), the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.marks: list[tuple[str, object]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict:
        """Each stage's time, after the device has passed the last mark."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[f"{name}_ms"] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def _publish_snapshot(spo, sort_perm, sorted_keys, clock: _StageClock):
    """Device-resident snapshot build: the publication step at a barrier.

    Gathers the live rows through the persistent sorted index (the
    ``(s,p,o)``-ordered view is the index itself) and derives the
    ``(p,o,s)``-ordered view with one stable sort of its keys through the
    dedup kernel (the reference's ``jnp.argsort``; padding rows keep their
    order, so every array equals the reference's over its whole padded
    length).  Returns ``(tri, keys, tri_pos, keys_pos, n_live)``, every
    tensor newly made (``keys`` a copy of the index) and ``n_live`` a 0-d
    tensor; padding rows carry KEY_MAX keys behind the live prefix.
    """
    tri = spo[sort_perm.to(I64)]
    live = sorted_keys < KEY_MAX
    n_live = live.sum()
    s, p, o = (tri[:, k].to(I64) for k in range(3))
    pos_keys = torch.where(live, (p << 42) | (o << 21) | s, KEY_MAX)
    keys = sorted_keys.clone()
    clock.mark("gather")
    perm2 = ops.dedup_order(pos_keys).to(I64)
    out = tri, keys, tri[perm2], pos_keys[perm2], n_live
    clock.mark("sort")
    return out


def state_from_arrays(arrays: dict, program: Program, r: int,
                      device: str | torch.device) -> EngineState:
    """An :class:`EngineState` on ``device`` from the reference state's
    arrays (numpy, single device: ``spo``, ``epoch``, ``marked``, ``tomb``,
    ``n_used``, ``rep``, ``sort_perm``, ``sorted_keys``).  ``rep`` must be
    compressed, as the reference's ``merge_pairs_jax`` leaves it."""
    tensors = {
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name, dtype in _STATE_ARRAYS.items()
    }
    return EngineState(**tensors, program=program, r=r,
                       stats=MatStats(mode="REW-torch"))


def state_to_arrays(state: EngineState) -> dict:
    """The state's arrays as numpy, under the reference's names."""
    return {name: getattr(state, name).cpu().numpy() for name in _STATE_ARRAYS}


class RoundLog:
    """The wall split of one ``materialise_state`` call or update (host
    clock).

    ``setup_s`` runs from the entry to the first round; each round records
    its wall, the time the host spent blocked on the device inside it
    (:meth:`read` synchronises before it reads) and its host reads; the
    time between rounds (a fused loop's exit handling) goes to
    ``between_s``, and the rest after the last round to ``stats_s``.  A
    round's wall less its wait is the host's time in it: launching its work
    and everything else on the host.  ``wait_s`` sums every read of the
    call, in rounds or not, the synchronise and the copy; with ``tags`` (the
    engine's :class:`DispatchCounter`) ``phase_wait_s`` splits it by the
    phase tag each read ran under.  A capacity restart starts a new log,
    handed the one before as ``prior``: its rounds start anew, its
    ``wait_s`` and ``phase_wait_s`` go on summing the reads of every
    attempt.  With the spans on each round is a ``rew.round`` range and
    each read a ``rew.read`` one.
    """

    def __init__(self, device: torch.device, tags: DispatchCounter | None = None,
                 prior: RoundLog | None = None) -> None:
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.t0 = time.perf_counter()
        self.setup_s: float | None = None
        self.rounds: list[dict] = []
        self.between_s = 0.0
        self.stats_s = 0.0
        self.reads = 0  # reads outside rounds
        self.wait_s = prior.wait_s if prior is not None else 0.0  # every read's time
        self.tags = tags
        self.phase_wait: dict[str | None, float] = (
            dict(prior.phase_wait) if prior is not None else {})
        self._t: float | None = None
        self._end: float | None = None
        self._wait = 0.0
        self._reads = 0
        self._span = None

    def begin_round(self) -> None:
        now = time.perf_counter()
        if self.setup_s is None:
            self.setup_s = now - self.t0
        elif self._end is not None:
            self.between_s += now - self._end
        self._t, self._wait, self._reads = now, 0.0, 0
        self._span = spans.open_span("rew.round")

    def read(self, fn):
        """``fn()`` after the device has caught up; timed and counted."""
        with spans.span("rew.read"):
            t = time.perf_counter()
            if self.stream is not None:
                self.stream.synchronize()
            if self._t is None:
                self.reads += 1
            else:
                self._wait += time.perf_counter() - t
                self._reads += 1
            out = fn()
        took = time.perf_counter() - t
        self.wait_s += took
        if self.tags is not None:
            tag = self.tags.phase
            self.phase_wait[tag] = self.phase_wait.get(tag, 0.0) + took
        return out

    def end_round(self) -> None:
        self._end = time.perf_counter()
        self.rounds.append(dict(wall_s=self._end - self._t, wait_s=self._wait,
                                reads=self._reads))
        self._t = None
        spans.close_span(self._span)
        self._span = None

    def finish(self) -> dict:
        """The split as a dict, the stats time counted from the last round."""
        now = time.perf_counter()
        if self.setup_s is None:
            self.setup_s = now - self.t0
        self.stats_s = now - (self._end if self._end is not None
                              else self.t0 + self.setup_s)
        out = dict(
            setup_s=self.setup_s,
            rounds=self.rounds,
            between_s=self.between_s,
            stats_s=self.stats_s,
            wall_s=now - self.t0,
            reads=sum(r["reads"] for r in self.rounds) + self.reads,
            wait_s=self.wait_s,
        )
        if self.tags is not None:
            out["phase_wait_s"] = dict(self.phase_wait)
        return out


# what the host loop reads of process_candidates' flags each round
_ROUND_READ = ("ov_store", "ov_rewrite", "ov_route", "ov_pair",
               "contradiction", "rep_changed", "n_new", "n_pairs",
               "n_reflexive")


class TorchEngine:
    """REW materialisation with static capacities on one device, and its
    incremental maintenance.

    Runs on the card unless the caller passes ``device="cpu"``; with no card
    and no explicit CPU device, construction raises.  ``materialise``
    restarts with the exhausted capacity doubled on overflow, and
    :meth:`add_facts` / :meth:`delete_facts` roll an update back and retry
    it, so callers normally never see :class:`CapacityError`.

    ``fuse_rounds`` (default True, as the reference's) runs the rounds at
    the stream width through the fused loop (:mod:`repro_torch.core.fused`)
    and a delete's overdelete waves through the fused wave loop; False
    keeps the host loops.  On the card a fused round and a fused wave are
    each one replay of a captured CUDA graph; the engine keeps its graphs
    across calls, keyed by width, capacities and plans, and frees them when
    a capacity grows.  On the CPU the same bodies run eagerly.

    Updates emit into narrow delta buffers (``delta_out`` / ``delta_bind``
    / ``delta_rewrite``, the reference's defaults); an update that
    overflows one retries on the wide base-run buffers, sticky for 4
    updates.  ``rederive_mode`` is the delete side's rederivation:
    "targeted" (head-bound joins from the overdeleted instances) or
    "requeue" (whole rules).  ``seed_chunk`` pads every query batch of the
    delete path to a multiple of it (one call a batch).  ``last_split``
    holds the last call's wall split.  ``dispatches`` counts the units of
    work by the reference's family names (graph captures under
    ``compiles``), on this rank.

    ``mesh`` (an :class:`~repro_torch.launch.mesh.EngineMesh`) shards the
    engine over its ranks, one process each, as the reference's ``mesh=``
    does over its devices: every capacity is then per rank, ``route_cap``
    (None: gather every candidate on every rank) sizes the owner-routing
    buckets and ``pair_cap`` the sameAs pairs each rank sends; every rank
    makes the same calls in the same order, with the same arguments (the
    state it returns is its shard).  The rounds run eagerly under a mesh
    (``last_split["graphs"]`` is False, with the reason).
    """

    def __init__(
        self,
        n_resources: int,
        capacity: int = 1 << 12,
        bind_cap: int = 1 << 12,
        out_cap: int = 1 << 12,
        rewrite_cap: int = 1 << 12,
        delta_window: int = 4096,
        device: str | torch.device = "cuda",
        fuse_rounds: bool = True,
        seed_chunk: int = 2048,
        delta_out_cap: int | None = None,
        rederive_mode: str = "targeted",
        mesh=None,
        route_cap: int | None = None,
    ) -> None:
        self.device = resolve(device, "TorchEngine")
        self.n_resources = n_resources
        self.capacity = capacity
        self.bind_cap = bind_cap
        self.out_cap = out_cap
        self.rewrite_cap = rewrite_cap
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else int(mesh.world)
        self.route_cap = route_cap
        # the sameAs pair rows each rank sends in routed mode; grows on its
        # own, so a burst of pairs is not taken for a route overflow
        self.pair_cap = min(out_cap, 4096)
        # bounded per-round window of fresh rows the host reads back for the
        # next round's plan-skipping masks; rounds that insert more fall back
        # to all-True masks (sound, unfiltered; stats.delta_mask_fallbacks)
        self.delta_window = delta_window
        self.seed_chunk = seed_chunk
        # the narrow buffers of updates (the base run uses the wide ones)
        self.delta_out = delta_out_cap or min(out_cap, max(1 << 12, out_cap >> 4))
        self.delta_bind = min(bind_cap, max(1 << 13, bind_cap >> 4))
        self.delta_rewrite = min(rewrite_cap, max(1 << 11, rewrite_cap >> 4))
        if rederive_mode not in ("targeted", "requeue"):
            raise ValueError(f"unknown rederive_mode {rederive_mode!r}")
        self.rederive_mode = rederive_mode
        self.fuse_rounds = fuse_rounds
        self._delta_fallback = False  # sticky wide-buffer retry of updates
        self._fallback_since: int | None = None
        self._set_update_buffers(False)
        self._graphs: dict = {}  # captured fused rounds and waves by key
        # a graph cannot hold the collectives of a mesh: eager rounds there
        self._use_graphs = self.device.type == "cuda" and mesh is None
        self._graph = None  # the RoundGraph the last fused round ran on
        # the runtime half of the dispatch auditor: every unit of work the
        # reference dispatches as a compiled call, by family and phase
        self.dispatches = DispatchCounter()
        self._tables: tuple | None = None  # (program, device constant tables)
        self.last_split: dict | None = None
        self.last_publish: dict | None = None  # stage times of publish_snapshot
        self._log = RoundLog(self.device)
        self._sorts: torch.Tensor | None = None  # the spans' sort counter

    # -- buffers and capacities ----------------------------------------------
    def _set_update_buffers(self, updating: bool) -> None:
        """Select the buffers delta and tombstone plans emit into: the
        narrow delta buffers during an update (unless it falls back to the
        wide ones), the wide base-run buffers otherwise.  The active kind
        names the capacity a retry must grow."""
        narrow = updating and not self._delta_fallback
        self._updating = updating
        self._active_delta_out = self.delta_out if narrow else self.out_cap
        self._active_delta_kind = "delta_out" if narrow else "out"
        self._active_bind = self.delta_bind if narrow else self.bind_cap
        self._active_bind_kind = "delta_bind" if narrow else "bind"
        self._active_rewrite = self.delta_rewrite if narrow else self.rewrite_cap
        self._active_rewrite_kind = "delta_rewrite" if narrow else "rewrite"

    @classmethod
    def from_config(cls, cfg, mesh=None, **overrides):
        """An engine from a :mod:`repro_torch.configs.sameas_rew`
        ``EngineConfig``, on ``mesh`` if given; ``overrides`` replace its
        fields or add engine arguments (``device``, ``fuse_rounds``, ...).
        The config's ``route_cap`` (owner routing between shards) is
        honoured; without a mesh it routes nothing, as in the reference."""
        kw = dict(
            n_resources=cfg.n_resources,
            capacity=cfg.capacity,
            bind_cap=cfg.bind_cap,
            out_cap=cfg.out_cap,
            rewrite_cap=cfg.rewrite_cap,
            route_cap=cfg.route_cap,
            seed_chunk=cfg.seed_chunk,
            delta_out_cap=cfg.delta_out_cap,
        )
        kw.update(overrides)
        return cls(mesh=mesh, **kw)

    @property
    def _route(self) -> int | None:
        """The route buckets' rows, under a mesh only."""
        return self.route_cap if self.mesh is not None else None

    @property
    def captures(self) -> int:
        """Graphs captured by this engine."""
        return sum(self.dispatches.compiles.values())

    def captured_graphs(self) -> list[dict]:
        """Each graph this engine holds that has been captured: its
        ``family`` (``"fforward"`` a round, ``"fwave"`` a wave), ``key``,
        ``replays``, ``capture_s``, ``calls`` (a replay's launches by C
        entry point: the capture's own dict, which an ``ops.traced`` tracer
        was handed at each launch it recorded; read it, do not change it)
        and ``stages`` (the stage markers a replay runs, in order; empty
        for a graph captured with the spans off)."""
        return [dict(family=g.family, key=g.key, replays=g.replays,
                     capture_s=g.capture_s, calls=g.calls, stages=g.stages)
                for g in self._graphs.values() if g.graph is not None]

    def _free_graphs(self) -> None:
        """Drop every captured graph (their capacities are outgrown)."""
        if self._graphs:
            self._graphs.clear()
            self._graph = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _grow_for(self, kind: str) -> None:
        """Double exactly the capacity a :class:`CapacityError` names (x4
        for a wide one while an update is in its fallback retry).  A narrow
        delta buffer doubles for later updates, clamped at its wide
        buffer, and the running update retries on the wide buffers."""
        wide_factor = 4 if self._delta_fallback else 2
        if kind == "store":
            self.capacity *= 2
        elif kind == "bind":
            self.bind_cap *= wide_factor
        elif kind in ("out", "out_cap"):
            self.out_cap *= wide_factor
        elif kind == "rewrite":
            self.rewrite_cap *= wide_factor
        elif kind in ("delta_out", "delta_bind", "delta_rewrite"):
            wide = {"delta_out": "out_cap", "delta_bind": "bind_cap",
                    "delta_rewrite": "rewrite_cap"}[kind]
            if getattr(self, kind) < getattr(self, wide):
                setattr(self, kind, getattr(self, kind) * 2)
            self._delta_fallback = True
            self._fallback_since = None
        elif kind == "pair":
            self.pair_cap *= 2
        elif kind == "route" and self.route_cap is not None:
            self.route_cap *= 2
        else:  # an unknown kind grows everything
            for attr in ("capacity", "bind_cap", "delta_bind", "out_cap",
                         "delta_out", "rewrite_cap", "delta_rewrite",
                         "pair_cap"):
                setattr(self, attr, getattr(self, attr) * 2)
            if self.route_cap is not None:
                self.route_cap *= 2
        self._set_update_buffers(self._active_delta_kind == "delta_out")
        self._free_graphs()

    def _maybe_reset_fallback(self, state: EngineState) -> None:
        """The sticky wide-buffer fallback probes the narrow buffers again
        4 updates after it was entered."""
        if not self._delta_fallback:
            self._fallback_since = None
            return
        if self._fallback_since is None:
            self._fallback_since = state.update_epoch
        elif state.update_epoch - self._fallback_since >= 4:
            self._delta_fallback = False
            self._fallback_since = None

    def _presize_delta(self, n_rows: int) -> None:
        """Grow the delta buffers (and, past them, the wide ones) to hold a
        known cardinality — the admitted batch, the overdeleted rows — at a
        phase boundary, with no restart; at least the minimum width.
        ``n_rows`` is global and the caps per rank, so the width is its
        share of the ranks."""
        need = _pow2(-(-max(int(n_rows), 1) // self.n_shards))
        grew = False
        for attr, wide in (("delta_out", "out_cap"), ("delta_bind", "bind_cap"),
                           ("delta_rewrite", "rewrite_cap")):
            if getattr(self, wide) < need:
                setattr(self, wide, need)
                grew = True
            target = min(need, getattr(self, wide))
            if getattr(self, attr) < target:
                setattr(self, attr, target)
                grew = True
        self._set_update_buffers(True)
        if grew:
            self._free_graphs()

    # -- state lifecycle -----------------------------------------------------
    def _fresh_state(self, program: Program) -> EngineState:
        cap, dev = self.capacity, self.device
        return EngineState(
            spo=torch.zeros((cap + 1, 3), dtype=I32, device=dev),
            epoch=torch.full((cap + 1,), -1, dtype=I32, device=dev),
            marked=torch.zeros(cap + 1, dtype=torch.bool, device=dev),
            tomb=torch.full((cap + 1,), -1, dtype=I32, device=dev),
            n_used=torch.zeros(1, dtype=I32, device=dev),
            rep=torch.arange(self.n_resources, dtype=I32, device=dev),
            # a valid index of the empty store: KEY_MAX padding pointing at
            # the trash row
            sort_perm=torch.full((cap + 1,), cap, dtype=I32, device=dev),
            sorted_keys=torch.full((cap + 1,), KEY_MAX, dtype=I64, device=dev),
            program=program,
            r=0,
            stats=MatStats(mode="REW-torch" + ("-spmd" if self.mesh is not None
                                                 else "")),
        )

    def _pad_cands(self, rows: np.ndarray):
        """Pad a host candidate batch to the active stream width: the
        narrow ``delta_out`` during updates, ``out_cap`` in the base run.
        Under a mesh the batch is padded to the width times the ranks and
        each rank takes its block of rows, as the reference's ``P(axis)``
        splits the padded stream."""
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        width = self._active_delta_out
        if rows.shape[0] > width * self.n_shards:
            raise CapacityError(self._active_delta_kind)
        if self.mesh is not None:
            me = coll.axis_index(self.mesh)
            rows = rows[me * width:(me + 1) * width]
        with spans.span("rew.upload"):
            cands = torch.zeros((width, 3), dtype=I32, device=self.device)
            cands[: rows.shape[0]] = torch.from_numpy(rows).to(self.device)
            cand_valid = torch.arange(width, device=self.device) < rows.shape[0]
        return cands, cand_valid

    @staticmethod
    def _distinct_keys(cands, cand_valid):
        """The valid rows of a padded stream as sorted keys on its device
        (the stable dedup order of the packed keys) and the mask of each
        key's first occurrence."""
        with spans.span("rew.distinct"):
            keys = torch.where(cand_valid, _pack3(cands), KEY_MAX)
            spans.count_sorted(cand_valid)
            sk = keys[ops.dedup_order(keys).to(I64)]
            first = torch.ones_like(cand_valid)
            first[1:] = sk[1:] != sk[:-1]
            return sk, first & (sk < KEY_MAX)

    def _grow_state_arena(self, state: EngineState, old_cap: int) -> None:
        """Re-layout the arena after ``capacity`` grew: the new rows are
        free, the old trash row becomes an ordinary free row, and the index
        is rebuilt at the next update's start."""
        extra = self.capacity - old_cap
        dev = self.device

        def grow(x, fill):
            pad = torch.full((extra, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
            return torch.cat([x, pad], dim=0)

        state.spo = grow(state.spo, 0)
        state.epoch = grow(state.epoch, -1)
        state.marked = grow(state.marked, False)
        state.tomb = grow(state.tomb, -1)
        state.index_dirty = True

    _SNAP_TENSORS = ("spo", "epoch", "marked", "tomb", "n_used", "rep",
                     "sort_perm", "sorted_keys", "explicit")

    @classmethod
    def _snapshot(cls, state: EngineState) -> dict:
        """What a rollback restores.  The round bodies write the arena in
        place, so every tensor is cloned (the reference keeps references
        to immutable arrays)."""
        snap = {f: getattr(state, f).clone() for f in cls._SNAP_TENSORS}
        for f in ("index_dirty", "program", "r", "update_epoch"):
            snap[f] = getattr(state, f)
        snap["stats"] = copy.copy(state.stats)
        return snap

    @staticmethod
    def _restore(state: EngineState, snap: dict) -> None:
        for f, v in snap.items():
            setattr(state, f, v)

    @classmethod
    def cloned(cls, state: EngineState) -> EngineState:
        """A copy of ``state`` whose tensors are clones."""
        out = dataclasses.replace(state)
        cls._restore(out, cls._snapshot(state))
        return out

    def _recover_capacity(self, state: EngineState, snap: dict,
                          err: CapacityError) -> None:
        """Roll back to ``snap``, grow the exhausted capacity and re-layout
        the arena if the store grew; books the retry.  Its dispatches count
        under the ``"retry"`` phase (the restarted generator tags its own)."""
        self.dispatches.phase = "retry"
        self._restore(state, snap)
        old_cap = self.capacity
        kind = str(err)
        self._grow_for(kind)
        if self.capacity != old_cap:
            self._grow_state_arena(state, old_cap)
        state.stats.capacity_retries += 1
        if kind in ("bind", "out", "out_cap", "rewrite"):
            state.stats.wide_growth_restarts += 1

    def _ensure_index(self, state: EngineState) -> None:
        """Rebuild the sorted index if the arena was re-laid out."""
        if not state.index_dirty:
            return
        self.dispatches.record("rebuild_index")
        state.sort_perm, state.sorted_keys = _rebuild_index(
            state.spo, state.epoch, state.marked)
        state.index_dirty = False
        state.stats.index_rebuilds += 1

    def _barrier(self, state: EngineState, sorts: torch.Tensor | None = None) -> dict:
        """An update's fixpoint is complete (no-effect updates too); returns
        :meth:`_refresh_stats`' sort counts."""
        state.update_epoch += 1
        return self._refresh_stats(state, sorts)

    def _grow_rep(self, state: EngineState, hi: int) -> None:
        """Extend rho with identities up to id ``hi`` (exclusive)."""
        if hi > state.n_res:
            ext = torch.arange(state.n_res, hi, dtype=I32, device=self.device)
            state.rep = torch.cat([state.rep, ext])

    def _bucket_cands(self, bufs):
        """Concatenate plan output buffers, padding each width group with
        empty buffers to a power-of-two count (the reference's bucketing,
        kept so the candidate stream has the same rows in the same order).

        Under a mesh each buffer is a rank's block of a global buffer, and
        the reference concatenates the global buffers and splits the result
        by rows again, so a rank's block of the stream holds other ranks'
        rows: every rank gathers the blocks and takes its own."""
        groups: dict[int, list] = {}
        for b in bufs:
            groups.setdefault(int(b[0].shape[0]), []).append(b)
        heads, valids, widths = [], [], []
        for rows, bs in sorted(groups.items()):
            total = 1
            while total < len(bs):
                total *= 2
            pad = total - len(bs)
            heads += [b[0] for b in bs]
            valids += [b[1] for b in bs]
            widths += [rows] * len(bs)
            if pad:
                heads.append(torch.zeros((rows * pad, 3), dtype=I32,
                                         device=self.device))
                valids.append(torch.zeros(rows * pad, dtype=torch.bool,
                                          device=self.device))
                widths += [rows] * pad
        cands, valid = torch.cat(heads, dim=0), torch.cat(valids, dim=0)
        if self.mesh is None:
            return cands, valid
        D, n = self.n_shards, cands.shape[0]
        rows, ok = _gather_rows(cands, valid, self.mesh)
        rows, ok = rows.view(D, n, 3), ok.view(D, n)
        parts, oks, at = [], [], 0
        for w in widths:  # each global buffer: its rank blocks in order
            parts.append(rows[:, at:at + w].reshape(D * w, 3))
            oks.append(ok[:, at:at + w].reshape(D * w))
            at += w
        me = coll.axis_index(self.mesh)
        mine = slice(me * n, (me + 1) * n)
        return torch.cat(parts, dim=0)[mine], torch.cat(oks, dim=0)[mine]

    def _psum_host(self, values: torch.Tensor) -> np.ndarray:
        """One host read of a vector of counts and bits (int64), summed
        over the ranks under a mesh: a bit read ``> 0`` is any rank's."""
        if self.mesh is not None:
            values = coll.psum(values, self.mesh)
        return self._log.read(values.cpu().numpy)

    def _refresh_stats(self, state: EngineState,
                       sorts: torch.Tensor | None = None) -> dict:
        """The store's counters, in one host read of the call's log (the
        rows of every rank's shard; rho is the same on each).  The same
        read takes the call's sort counter ``sorts`` where it has one
        (:meth:`_sort_counter`, spans on): returns ``{"sort_keys",
        "sort_pad_keys"}``, else an empty dict."""
        ids = torch.arange(state.n_res, dtype=I32, device=self.device)
        stats = state.stats
        used = state.n_used.sum().to(I64)
        if self.mesh is not None:
            used = coll.psum(used, self.mesh)
        vals = [used, (state.rep != ids).sum()]
        if sorts is not None:
            vals += [sorts[0], sorts[0] - sorts[1]]
        stats.triples_total, stats.merged_resources, *counts = self._log.read(
            torch.stack(vals).tolist)
        stats.triples_explicit = int(state.explicit.shape[0])
        return dict(zip(("sort_keys", "sort_pad_keys"), counts))

    def _sort_counter(self) -> torch.Tensor | None:
        """With the spans on, this engine's sort counter, zeroed for a new
        call (``int64 [keys, valid keys]``, made once so that every graph
        captured by the engine adds into it); else None."""
        if not spans.enabled():
            return None
        if self._sorts is None:
            self._sorts = torch.zeros(2, dtype=I64, device=self.device)
        else:
            self._sorts.zero_()
        return self._sorts

    def gathered_state(self, state: EngineState) -> EngineState:
        """Under a mesh, the state with every rank's shard of the arena,
        ``n_used`` and the index concatenated in shard order: the global
        arrays of the reference's state (rho and the rest are shared).
        Without one, ``state``."""
        if self.mesh is None:
            return state
        arrays = {f: coll.all_gather(getattr(state, f), self.mesh)
                  for f in ("spo", "epoch", "marked", "tomb", "n_used",
                            "sort_perm", "sorted_keys")}
        return dataclasses.replace(state, **arrays)

    def state_triples(self, state: EngineState) -> np.ndarray:
        """The current normal-form store as a host (n, 3) array (every
        shard's rows, in shard order, under a mesh)."""
        state = self.gathered_state(state)
        live = (state.epoch >= 0) & ~state.marked
        state.stats.triples_unmarked = int(live.sum())
        return state.spo[live].cpu().numpy()

    def state_rep(self, state: EngineState) -> np.ndarray:
        """rho on the host; ``merge_pairs`` leaves it compressed."""
        return state.rep.to("cpu", copy=True).numpy()

    @staticmethod
    def explicit_rows(state: EngineState) -> np.ndarray:
        """The explicit fact set as host (n, 3) rows, in key order."""
        return _unpack3(state.explicit).cpu().numpy()

    # -- epoch snapshots (the serving tier's read views) ---------------------
    def snapshot_arrays(self, spo, epoch, marked, rep, at_epoch: int,
                        sort_perm=None, sorted_keys=None,
                        index_dirty: bool = True) -> StoreSnapshot:
        """A host :class:`StoreSnapshot` from barrier-consistent arrays (a
        state between updates, or the rollback snapshot of an update in
        flight).  With a clean sorted index the live rows come out through
        it, in packed-key order; otherwise by a scan of the arena."""
        if sorted_keys is not None and not index_dirty:
            D = self.n_shards
            perm = sort_perm.view(D, -1).to(I64)
            base = torch.arange(D, device=perm.device)[:, None] * perm.shape[1]
            live = (perm + base)[sorted_keys.view(D, -1) < KEY_MAX]
            triples = spo[live].cpu().numpy()
        else:
            triples = spo[(epoch >= 0) & ~marked].cpu().numpy()
        triples.setflags(write=False)  # shared by every reader at this epoch
        return StoreSnapshot(at_epoch, FrozenRho(rep.cpu().numpy()), triples=triples)

    def read_snapshot(self, state: EngineState) -> StoreSnapshot:
        """Epoch-versioned host snapshot (host triples and a frozen rho);
        valid at an epoch barrier only (no update in flight on ``state``).
        Under a mesh the triples are every shard's, in shard order, each
        shard's in key order."""
        state = self.gathered_state(state)
        snap = self.snapshot_arrays(
            state.spo, state.epoch, state.marked, state.rep, state.update_epoch,
            sort_perm=state.sort_perm, sorted_keys=state.sorted_keys,
            index_dirty=state.index_dirty,
        )
        state.stats.triples_unmarked = int(snap.triples.shape[0])
        return snap

    def publish_snapshot(self, state: EngineState,
                         prev: StoreSnapshot | None = None) -> StoreSnapshot:
        """Device-resident epoch snapshot: the serving publication step.

        Valid at an epoch barrier only.  Keeps the live rows on the device
        in the two sorted orders the batched matcher probes
        (:func:`_publish_snapshot`), every tensor newly made; reads
        ``n_live`` and rho to the host in one copy; ``prev`` (the previous
        snapshot) gives the incremental
        :meth:`~repro_torch.core.uf.FrozenRho.refreshed` rho refresh.  On
        the card the snapshot carries an event recorded after its last
        write.  ``last_publish`` gets the stage times in ms: ``gather``
        and ``sort`` (device time on the card), ``read`` and ``rho``
        (host clock).  Dispatches count under the ``"publish"`` phase.

        Under a mesh it takes the host path, :meth:`read_snapshot`, as the
        reference does: the shards' sorted blocks are no globally sorted
        view, and the serving tier is single-device.
        """
        if self.mesh is not None:
            snap = self.read_snapshot(state)
            if prev is not None:
                snap.rho = prev.rho.refreshed(self.state_rep(state))
            return snap
        clock = _StageClock(self.device)
        prev_phase = self.dispatches.phase
        self.dispatches.phase = "publish"
        try:
            self._ensure_index(state)
            self.dispatches.record("snapshot")
            tri, keys, tri_pos, keys_pos, n_live = _publish_snapshot(
                state.spo, state.sort_perm, state.sorted_keys, clock)
        finally:
            self.dispatches.phase = prev_phase
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        t0 = time.perf_counter()
        host = torch.cat([n_live.to(I32).view(1), state.rep]).cpu().numpy()
        t1 = time.perf_counter()
        n_live, rep_host = int(host[0]), host[1:]
        rho = (prev.rho.refreshed(rep_host) if prev is not None
               else FrozenRho(rep_host))
        self.last_publish = dict(clock.ms(), read_ms=(t1 - t0) * 1e3,
                                 rho_ms=(time.perf_counter() - t1) * 1e3)
        state.stats.triples_unmarked = n_live
        return StoreSnapshot(state.update_epoch, rho,
                             device=(tri, keys, tri_pos, keys_pos, n_live),
                             ready=ready)

    # -- rule evaluation -----------------------------------------------------
    def _rewrite_program(self, state: EngineState, stats: MatStats):
        """Rewrite the program under the current rho and classify each
        changed rule (Algorithm 1 lines 6-9).  Returns ``(merge_q,
        full_q)``: ``[(rule, anchor atom)]`` for merge-targeted evaluation
        (only while updating in "targeted" mode) and the rules requeued
        for full evaluation."""
        with spans.span("rew.rewrite_program"):
            rep = self._log.read(lambda: self.state_rep(state))
            p_old = state.program
            p_new, changed_idx = p_old.rewrite(rep)
            merge_q: list[tuple[int, int]] = []
            full_q: list[int] = []
            if changed_idx:
                stats.rule_rewrites += 1
                stats.rules_requeued += len(changed_idx)
                targeted = self._updating and self.rederive_mode == "targeted"
                for k in changed_idx:
                    if not targeted:
                        full_q.append(k)
                        continue
                    how, anchor = classify_remerge(p_old.rules[k], p_new.rules[k])
                    if how == "anchor":
                        merge_q.append((k, anchor))
                    elif how == "full":
                        full_q.append(k)
                        stats.remerge_full_fallback += 1
            state.program = p_new
            return merge_q, full_q

    def _program_tables(self, program: Program):
        """The program's constant tables on the device, made once a program."""
        if self._tables is None or self._tables[0] is not program:
            from .fused import program_tables

            ac, hc, _, _ = program_tables(program)
            self._tables = (program, torch.from_numpy(ac).to(self.device),
                            torch.from_numpy(hc).to(self.device))
        return self._tables[1], self._tables[2]

    @staticmethod
    def _atom_may_match(atom, masks: np.ndarray) -> bool:
        """False iff a constant position of ``atom`` misses the delta masks
        (so the plan's delta atom cannot bind any fresh row)."""
        for pos, t in enumerate(atom):
            if not is_var(t) and not masks[pos][t]:
                return False
        return True

    def _read_ints(self, tensors) -> list[int]:
        """One host read of a plan's 0-d counts and overflow bits (summed
        over the ranks under a mesh)."""
        return self._psum_host(torch.stack([t.to(I64) for t in tensors])).tolist()

    def _eval_rule(self, state: EngineState, r: int, k: int, mode: str,
                   stats: MatStats | None, delta_masks: np.ndarray | None = None):
        """Evaluate the plans of rule ``k``; ``mode`` is "delta", "full" or
        "tomb" (the overdelete plans at wave ``r``, which count nothing:
        pass ``stats=None``).  Full plans emit into the wide buffers, the
        others into the active ones.  ``delta_masks`` (3, n_res) skips
        delta and tombstone plans whose delta atom cannot match."""
        rule = state.program.rules[k]
        atom_consts, head_consts = self._program_tables(state.program)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        full = mode == "full"
        out_cap = self.out_cap if full else self._active_delta_out
        bind_cap = self.bind_cap if full else self._active_bind
        out = []
        for i, plan in enumerate(build_plans(rule, full=full,
                                             tombstone=mode == "tomb")):
            if (
                delta_masks is not None
                and not full
                and not self._atom_may_match(rule.body[i], delta_masks)
            ):
                continue
            self.dispatches.record("plan")
            heads, valid, *counts = eval_plan(
                state.spo, state.epoch, state.marked, state.sorted_keys,
                state.sort_perm, r, atom_consts[k], head_consts[k],
                tuple(plan), head_slots, bind_cap, out_cap, tomb=state.tomb,
                mesh=self.mesh,
            )
            n_d, n_a, ov_bind, ov_out = self._read_ints(counts)
            if ov_bind:
                raise CapacityError("bind" if full else self._active_bind_kind)
            if ov_out:
                raise CapacityError("out" if full else self._active_delta_kind)
            if stats is not None:
                stats.derivations += n_d
                stats.rule_applications += n_a
                if full:
                    stats.full_plan_evals += 1
            out.append((heads, valid))
        return out

    @staticmethod
    def _rule_tables(rule: Rule):
        """One rule's constants: ``(atom_consts (n_atoms, 3), head_consts
        (3,))`` as nested lists, variables as 0."""
        atom_consts = [[0 if is_var(t) else t for t in atom] for atom in rule.body]
        head_consts = [0 if is_var(t) else t for t in rule.head]
        return atom_consts, head_consts

    def _eval_rule_merge(self, state: EngineState, r: int, k: int, anchor: int,
                         stats: MatStats):
        """Merge-targeted evaluation of rewritten rule ``k``: one plan
        anchored at its changed body atom, at the active delta buffers."""
        rule = state.program.rules[k]
        atom_consts, head_consts = self._rule_tables(rule)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        self.dispatches.record("mplan")
        heads, valid, *counts = eval_plan(
            state.spo, state.epoch, state.marked, state.sorted_keys,
            state.sort_perm, r, atom_consts, head_consts,
            tuple(build_merge_plan(rule, anchor)), head_slots,
            self._active_bind, self._active_delta_out, tomb=state.tomb,
            mesh=self.mesh,
        )
        n_d, n_a, ov_bind, ov_out = self._read_ints(counts)
        if ov_bind:
            raise CapacityError(self._active_bind_kind)
        if ov_out:
            raise CapacityError(self._active_delta_kind)
        stats.derivations += n_d
        stats.rule_applications += n_a
        stats.remerge_targeted += 1
        return [(heads, valid)]

    def _eval_rule_rederive(self, state: EngineState, k: int, rule: Rule,
                            seeds: np.ndarray) -> np.ndarray:
        """Head-bound rederivation of ``rule`` from the (m, n_head_vars)
        host table of head-variable bindings (:func:`build_rederive_plan`'s
        column order); returns the restored instances as host rows."""
        plan, seed_vars = build_rederive_plan(rule)
        atom_consts, head_consts = self._rule_tables(rule)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        seeds = np.asarray(seeds, np.int32)
        if seeds.ndim != 2 or seeds.shape[1] != len(seed_vars):
            raise ValueError(f"seed table shape {seeds.shape} does not match "
                             f"the head's variable order {seed_vars}")
        cap = max(64, _pow2(seeds.shape[0]))
        seeds_t = torch.zeros((cap, len(seed_vars)), dtype=I32, device=self.device)
        seeds_t[: seeds.shape[0]] = torch.from_numpy(seeds).to(self.device)
        valid_t = torch.arange(cap, device=self.device) < seeds.shape[0]
        stats = state.stats
        stats.rederive_seed_rows += int(seeds.shape[0])
        stats.rederive_join_width = max(stats.rederive_join_width, cap)
        self.dispatches.record("rplan")
        out, valid, *counts = eval_plan_rederive(
            state.spo, state.epoch, state.marked, state.sorted_keys,
            state.sort_perm, atom_consts, head_consts, seeds_t, valid_t,
            tuple(plan), head_slots, seed_vars, self._active_bind,
            self._active_delta_out, tomb=state.tomb, mesh=self.mesh,
        )
        n_d, ov_bind, ov_out = self._read_ints(counts)
        if ov_bind:
            raise CapacityError(self._active_bind_kind)
        if ov_out:
            raise CapacityError(self._active_delta_kind)
        stats.derivations += n_d
        if self.mesh is not None:  # every rank's rows, in rank order
            out, valid = _gather_rows(out, valid, self.mesh)
        return self._log.read(lambda: out[valid].cpu().numpy())

    def _stream_of(self, bufs, had_full: bool):
        """The next round's stream from plan buffers: bucketed, squeezed to
        ``out_cap`` after a round that evaluated full plans, else to the
        active delta width, when wider.  Returns ``(cands, cand_valid,
        have_cands)``."""
        cands, cand_valid = self._bucket_cands(bufs)
        target = self.out_cap if had_full else self._active_delta_out
        kind = "out" if had_full else self._active_delta_kind
        sq_ov = torch.zeros((), dtype=torch.bool, device=self.device)
        if cands.shape[0] > target:
            self.dispatches.record("squeeze")
            cands, cand_valid, sq_ov = _squeeze_stream(cands, cand_valid, target)
        ov, have = self._psum_host(
            torch.stack([sq_ov, cand_valid.any()]).to(I64)).tolist()
        if ov:
            raise CapacityError(kind)
        return cands, cand_valid, bool(have)

    def _round_plans(self, state: EngineState, r: int, merge_q, full_q,
                     stats: MatStats, delta_masks=None, with_delta=True):
        """A host round's plan evaluation at ``r``: the delta plans (if the
        round inserted rows), the merge-targeted plans and the requeued
        full plans.  Returns the next stream as :meth:`_stream_of` does,
        or ``(None, None, False)`` when no plan ran."""
        bufs = []
        if with_delta:
            for k in range(len(state.program.rules)):
                bufs += self._eval_rule(state, r, k, "delta", stats,
                                        delta_masks=delta_masks)
        for k, anchor in merge_q:
            bufs += self._eval_rule_merge(state, r, k, anchor, stats)
        for k in sorted(set(full_q)):
            bufs += self._eval_rule(state, r, k, "full", stats)
        if not bufs:
            return None, None, False
        return self._stream_of(bufs, had_full=bool(full_q))

    # -- driver --------------------------------------------------------------
    def _forward(self, state: EngineState, cands, cand_valid,
                 requeued: list[int], max_rounds: int) -> None:
        """The bulk-synchronous round loop, from ``state`` to the fixpoint:
        the base run (seeded with the facts), additions (the delta) and the
        delete path's forward pass (the rederivation seeds and the requeued
        rules).  ``state.r`` keeps growing across calls.

        As the reference's: with ``fuse_rounds``, a stream at the active
        delta width with no rule awaiting full evaluation runs through the
        fused loop (:meth:`_fused_forward`); any other round is a host
        round.
        """
        stats = state.stats
        log = self._log
        mesh = self.mesh
        requeued = list(requeued)
        rounds_here = 0
        have_cands = True
        while have_cands or requeued:
            if (self.fuse_rounds and not requeued
                    and cands.shape[0] == self._active_delta_out):
                if rounds_here >= max_rounds:
                    raise RuntimeError("did not converge")
                iters, cands, cand_valid, have_cands = self._fused_forward(
                    state, cands, cand_valid, max_rounds - rounds_here
                )
                rounds_here += iters
                continue
            state.r += 1
            r = state.r
            stats.rounds += 1
            rounds_here += 1
            if rounds_here > max_rounds:
                raise RuntimeError("did not converge")
            log.begin_round()
            self.dispatches.record("process")
            (state.spo, state.epoch, state.marked, state.n_used, state.rep,
             state.sort_perm, state.sorted_keys, fl) = process_candidates(
                state.spo, state.epoch, state.marked, state.n_used, state.rep,
                state.sort_perm, state.sorted_keys, cands, cand_valid, r,
                self._active_rewrite, self.delta_window, mesh=mesh,
                route_cap=self._route, pair_cap=self.pair_cap,
            )
            # the round's one host read: its counts and bits, then the
            # delta (every rank's, gathered in rank order, under a mesh)
            vec = torch.cat([
                torch.stack([fl[k].to(I64).reshape(()) for k in _ROUND_READ]),
                fl["delta_rows"].reshape(-1).to(I64)])
            if mesh is not None:
                vec = coll.all_gather(vec, mesh)
            host = log.read(lambda: vec.view(self.n_shards, -1).cpu().numpy())
            per_rank = host[:, :len(_ROUND_READ)]
            flags = dict(zip(_ROUND_READ, per_rank.sum(axis=0).tolist()))
            for kind in ("store", "rewrite", "route", "pair"):
                if flags["ov_" + kind]:
                    raise CapacityError(
                        self._active_rewrite_kind if kind == "rewrite" else kind)
            if flags["contradiction"]:
                raise Contradiction("owl:differentFrom violation")
            stats.sameas_pairs += flags["n_pairs"]
            stats.reflexive_added += flags["n_reflexive"]
            stats.derivations += flags["n_reflexive"]
            merge_q: list[tuple[int, int]] = []
            if flags["rep_changed"]:
                mq, full_q = self._rewrite_program(state, stats)
                merge_q += mq
                requeued += full_q

            # evaluate plans for the new delta, skipping plans whose delta
            # atom is incompatible with the fresh rows' resource masks
            delta_masks = None
            n_new = flags["n_new"]
            if n_new > 0:
                d_rows = host[:, len(_ROUND_READ):].reshape(self.n_shards, -1, 3)
                n_rank = per_rank[:, _ROUND_READ.index("n_new")]
                if (n_rank > d_rows.shape[1]).any():
                    stats.delta_mask_fallbacks += 1
                    delta_masks = np.ones((3, state.n_res), dtype=bool)
                else:
                    delta_masks = np.zeros((3, state.n_res), dtype=bool)
                    for rows, n in zip(d_rows, n_rank):
                        for pos in range(3):
                            delta_masks[pos][rows[:n, pos]] = True
            cands, cand_valid, have_cands = self._round_plans(
                state, r + 1, merge_q, requeued, stats, delta_masks,
                with_delta=n_new > 0)
            requeued = []
            log.end_round()

    def _round_graph(self, state: EngineState, cands, cand_valid, plans):
        """The engine's captured round for this key, made on first use.
        rho lives in a power-of-two buffer in the graph, so an update that
        interns new ids replays the same graph; the constant tables are as
        wide as the base program's."""
        from .fused import RoundGraph, program_tables

        n_pad = _pow2(state.n_res)
        # rewriting only merges constants: the base program's count bounds
        # every rewriting's (a split un-merges them again)
        width = program_tables(state.base_program)[2].shape[0]
        key = ("round", int(cands.shape[0]), plans, self.capacity,
               self._active_bind, self._active_delta_out, self._active_rewrite,
               n_pad, width)
        graph = self._graphs.get(key)
        if graph is None:
            graph = RoundGraph(
                key, state, cands, cand_valid, plans,
                dict(rewrite_cap=self._active_rewrite, bind_cap=self._active_bind,
                     plan_out_cap=self._active_delta_out), n_pad, width,
            )
            self._graphs[key] = graph
        self._graph = graph
        return graph

    def _fused_forward(self, state: EngineState, cands, cand_valid,
                       rounds_left: int):
        """Run forward rounds through the fused loop.

        Returns ``(iters, cands, cand_valid, have_cands)``.  Convergence
        returns an empty stream; a rho-reaches-a-rule-constant exit rewrites
        the program, evaluates the exit round's delta plans (the loop
        nullified its own evaluation of that round), the merge-targeted
        plans and the requeued rules' full plans on the host, and hands the
        stream back to the round loop.  Overflow and contradiction raise
        what the host loop raises.
        """
        from .fused import forward_plan_signature, fused_forward_rounds

        stats = state.stats
        plans = forward_plan_signature(state.program)
        graph = (self._round_graph(state, cands, cand_valid, plans)
                 if self._use_graphs else None)
        cands, cand_valid, fl = fused_forward_rounds(
            state, cands, cand_valid, rounds_left, plans=plans,
            rewrite_cap=self._active_rewrite, bind_cap=self._active_bind,
            plan_out_cap=self._active_delta_out, log=self._log, graph=graph,
            dispatches=self.dispatches, mesh=self.mesh,
            route_cap=self._route, pair_cap=self.pair_cap,
        )
        iters = fl["iters"]
        state.r += iters
        stats.rounds += iters
        stats.sameas_pairs += fl["n_pairs"]
        stats.reflexive_added += fl["n_reflexive"]
        stats.derivations += fl["n_reflexive"] + fl["n_deriv"]
        stats.rule_applications += fl["n_appl"]
        for kind in ("store", "rewrite", "route", "pair"):
            if fl["ov_" + kind]:
                raise CapacityError(
                    self._active_rewrite_kind if kind == "rewrite" else kind)
        if fl["contradiction"]:
            raise Contradiction("owl:differentFrom violation")
        if fl["ov_bind"]:
            raise CapacityError(self._active_bind_kind)
        if fl["ov_out"] or fl["ov_squeeze"]:
            raise CapacityError(self._active_delta_kind)
        if fl["consts_changed"]:
            merge_q, full_q = self._rewrite_program(state, stats)
            # the exit round's fresh rows are in the store, but no delta
            # mask was made of them: every delta plan runs (a plan that
            # could have been skipped matches no row and counts nothing)
            new_cands, new_valid, have = self._round_plans(
                state, state.r + 1, merge_q, full_q, stats,
                with_delta=fl["n_new"] > 0)
            if new_cands is not None:
                return iters, new_cands, new_valid, have
            return iters, cands, cand_valid, False
        if fl["have_cands"]:
            raise RuntimeError("did not converge")
        return iters, cands, cand_valid, False

    # -- public API ----------------------------------------------------------
    def materialise_state(self, facts, program: Program,
                          max_rounds: int = 10_000) -> EngineState:
        """Base REW fixpoint, restarting with grown capacities on overflow.
        The explicit set is kept on the device as the facts' sorted
        distinct keys, sorted by the dedup kernel.  With the spans on the
        call is a ``rew.materialise`` range and ``last_split`` also holds
        the keys handed to ``dedup_order`` and the padding among them
        (``sort_keys``, ``sort_pad_keys``, summed over every attempt, as
        ``wait_s`` is)."""
        sorts = self._sort_counter()
        with spans.span("rew.materialise"), spans.counting_sorts(sorts):
            t0 = time.perf_counter()
            facts = np.asarray(facts, np.int32).reshape(-1, 3)
            restarts = 0
            prior = None
            while True:
                self._log = RoundLog(self.device, prior=prior)
                try:
                    self._set_update_buffers(False)
                    state = self._fresh_state(program)
                    cands, cand_valid = self._pad_cands(facts)
                    if self.mesh is None:
                        sk, first = self._distinct_keys(cands, cand_valid)
                    else:  # every rank keeps the whole explicit set
                        all_f = torch.from_numpy(facts).to(self.device)
                        sk, first = self._distinct_keys(
                            all_f, torch.ones(all_f.shape[0], dtype=torch.bool,
                                              device=self.device))
                    self._forward(state, cands, cand_valid, [], max_rounds)
                    break
                except CapacityError as e:
                    self._grow_for(str(e))
                    restarts += 1
                    prior = self._log
            state.stats.capacity_retries = restarts
            with spans.span("rew.stats"):
                state.explicit = self._log.read(lambda: sk[first])
                counts = self._refresh_stats(state, sorts)
            state.stats.wall_seconds += time.perf_counter() - t0
            self.last_split = self._log.finish()
            self.last_split.update(self._graphs_note(), **counts)
            if self._graph is not None:
                self.last_split["capture_s"] = self._graph.capture_s
            return state

    def _graphs_note(self) -> dict:
        """Whether the rounds ran as CUDA graphs, and why not if not."""
        if self._use_graphs:
            return dict(graphs=True)
        why = ("a graph cannot hold the mesh's collectives"
               if self.mesh is not None else "the CPU has no graphs")
        return dict(graphs=False, graphs_reason=why)

    def materialise(self, facts, program: Program, max_rounds: int = 10_000):
        """REW materialisation: ``(live triples, compressed rho, stats)``."""
        state = self.materialise_state(facts, program, max_rounds)
        return self.state_triples(state), self.state_rep(state), state.stats

    def add_facts(self, state: EngineState, delta, max_rounds: int = 10_000,
                  retry: bool = True) -> EngineState:
        """Add explicit triples and maintain the store on the device."""
        return self._apply_update(state, "add", delta, max_rounds, retry)

    def delete_facts(self, state: EngineState, delta, max_rounds: int = 10_000,
                     retry: bool = True) -> EngineState:
        """Retract explicit triples: tombstone waves, clique split and
        rederivation on the device (:mod:`repro_torch.core.incremental_spmd`)."""
        return self._apply_update(state, "delete", delta, max_rounds, retry)

    def _apply_update(self, state, op, delta, max_rounds, retry):
        """Run an update's phases to its epoch barrier, rolling back and
        retrying with the exhausted capacity grown on overflow.
        ``last_split`` gets, on the host clock, the time from the last
        attempt's start to each phase label, the earlier attempts' time
        (``retries_s``) and the last attempt's (``attempt_s``, the snapshot
        included), the whole call's (``call_s``), every attempt's reads
        (``wait_s``, and ``phase_wait_s`` by phase tag; the barrier's under
        None), and the graphs captured.  With the spans on the call is a ``maint.add`` or
        ``maint.delete`` range holding ``maint.snapshot``, each phase's
        range and ``maint.barrier``, and ``last_split`` holds the sort
        counts as :meth:`materialise_state`'s does."""
        from .incremental_spmd import spmd_add_phases, spmd_delete_phases

        sorts = self._sort_counter()
        with spans.span(f"maint.{op}"), spans.counting_sorts(sorts):
            t0 = time.perf_counter()
            captures0 = self.captures
            self._maybe_reset_fallback(state)
            phases = spmd_add_phases if op == "add" else spmd_delete_phases
            attempts = 0
            prior = None
            while True:
                ta = time.perf_counter()
                with spans.span("maint.snapshot"):
                    snap = self._snapshot(state)
                attempts += 1
                self._log = RoundLog(self.device, self.dispatches, prior)
                marks = []
                try:
                    self._set_update_buffers(True)
                    for label in phases(self, state, delta, max_rounds):
                        marks.append((label, time.perf_counter() - ta))
                    break
                except CapacityError as e:
                    if not retry:
                        raise
                    self._recover_capacity(state, snap, e)
                    prior = self._log
            end = time.perf_counter()
            with spans.span("maint.barrier"):
                counts = self._barrier(state, sorts)
            done = time.perf_counter()
            state.stats.wall_seconds += done - t0
            self.last_split = dict(self._log.finish(), op=op, phases=marks,
                                   retries_s=ta - t0, attempt_s=end - ta,
                                   call_s=done - t0, attempts=attempts,
                                   captures=self.captures - captures0,
                                   **self._graphs_note(), **counts)
            return state

    def materialise_incremental(self, facts, program: Program, updates,
                                max_rounds: int = 10_000, on_device: bool = True):
        """Base REW materialisation, then maintenance through ``updates``,
        an iterable of ``("add" | "delete", delta)`` pairs (each delta an
        (n, 3) int array of explicit triples).  On the device by default;
        ``on_device=False`` replays the updates through the host subsystem
        (:mod:`repro_torch.core.incremental`).  Returns ``(spo, rep,
        stats)`` like :meth:`materialise`."""
        if on_device:
            state = self.materialise_state(facts, program, max_rounds)
            for op, delta in updates:
                if op == "add":
                    self.add_facts(state, delta, max_rounds)
                elif op in ("delete", "del"):
                    self.delete_facts(state, delta, max_rounds)
                else:
                    raise ValueError(f"unknown update op {op!r}")
            return self.state_triples(state), self.state_rep(state), state.stats

        from .incremental import IncrementalState, add_facts, delete_facts
        from .triples import TripleArena, dedup_rows

        spo, rep, stats = self.materialise(facts, program, max_rounds)
        arena = TripleArena()
        arena.add_batch(spo)
        p_cur, _ = program.rewrite(rep)
        host_state = IncrementalState(
            arena=arena, rep=rep.astype(np.int32), program=p_cur,
            base_program=program, explicit=dedup_rows(facts),
            n_resources=self.n_resources, stats=stats,
        )
        for op, delta in updates:
            if op == "add":
                add_facts(host_state, delta, max_rounds)
            elif op in ("delete", "del"):
                delete_facts(host_state, delta, max_rounds)
            else:
                raise ValueError(f"unknown update op {op!r}")
        host_state.result()  # refresh the triple and memory counters
        return host_state.triples(), host_state.rep, host_state.stats


# -- audit trace builders (repro_torch.analysis) -----------------------------
#
# Each unit runs once at the caller's probe geometry (the supplied engine
# and state), single-device and eager, on copies of the state where it
# writes in place; the widths are the reference's builders'.

def _zeros(shape, dtype, dev):
    return torch.zeros(shape, dtype=dtype, device=dev)


@register_auditable("plan")
def _audit_plan(engine, state):
    atom_consts, head_consts = engine._program_tables(state.program)
    for k, rule in enumerate(state.program.rules):
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        for mode, full, tomb in (("delta", False, False), ("full", True, False),
                                 ("tomb", False, True)):
            for i, plan in enumerate(build_plans(rule, full=full, tombstone=tomb)):
                yield f"plan:rule{k}:{mode}:{i}", (
                    lambda plan=plan, k=k, head_slots=head_slots: eval_plan(
                        state.spo, state.epoch, state.marked, state.sorted_keys,
                        state.sort_perm, 1, atom_consts[k], head_consts[k],
                        tuple(plan), head_slots, engine.bind_cap, engine.out_cap,
                        tomb=state.tomb))


@register_auditable("rplan")
def _audit_rplan(engine, state):
    dev = state.spo.device
    for k, rule in enumerate(state.program.rules):
        plan, seed_vars = build_rederive_plan(rule)
        if not seed_vars:
            continue  # variable-free head: whole-rule requeue fallback
        atom_consts, head_consts = engine._rule_tables(rule)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        seeds = _zeros((64, len(seed_vars)), I32, dev)
        seed_valid = _zeros(64, torch.bool, dev)
        yield f"rplan:rule{k}", (
            lambda plan=plan, seed_vars=seed_vars, ac=atom_consts, hc=head_consts,
            head_slots=head_slots, seeds=seeds, seed_valid=seed_valid:
            eval_plan_rederive(
                state.spo, state.epoch, state.marked, state.sorted_keys,
                state.sort_perm, ac, hc, seeds, seed_valid, tuple(plan),
                head_slots, seed_vars, engine.bind_cap, engine.out_cap,
                tomb=state.tomb))


@register_auditable("mplan")
def _audit_mplan(engine, state):
    # one run per (rule, anchor) the forward-side targeted re-merge can
    # dispatch: any body atom with a variable can be the changed anchor
    for k, rule in enumerate(state.program.rules):
        atom_consts, head_consts = engine._rule_tables(rule)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        for anchor in range(len(rule.body)):
            if not any(is_var(t) for t in rule.body[anchor]):
                continue
            plan = build_merge_plan(rule, anchor)
            yield f"mplan:rule{k}:anchor{anchor}", (
                lambda plan=plan, ac=atom_consts, hc=head_consts,
                head_slots=head_slots: eval_plan(
                    state.spo, state.epoch, state.marked, state.sorted_keys,
                    state.sort_perm, 1, ac, hc, tuple(plan), head_slots,
                    engine.bind_cap, engine.out_cap, tomb=state.tomb))


@register_auditable("process")
def _audit_process(engine, state):
    st = TorchEngine.cloned(state)
    dev = st.spo.device
    cands = _zeros((engine.out_cap, 3), I32, dev)
    cv = _zeros(engine.out_cap, torch.bool, dev)
    yield "process", lambda: process_candidates(
        st.spo, st.epoch, st.marked, st.n_used, st.rep, st.sort_perm,
        st.sorted_keys, cands, cv, 1, engine.rewrite_cap, engine.delta_window)


@register_auditable("squeeze")
def _audit_squeeze(engine, state):
    wide = 2 * engine.out_cap
    dev = state.spo.device
    cands = _zeros((wide, 3), I32, dev)
    valid = _zeros(wide, torch.bool, dev)
    yield "squeeze", lambda: _squeeze_stream(cands, valid, engine.out_cap)


@register_auditable("rebuild_index", skip_passes=("NoArenaSort",))
def _audit_rebuild_index(engine, state):
    # the one allowed arena sort (at most once per arena re-layout, counted
    # by stats.index_rebuilds)
    yield "rebuild_index", lambda: _rebuild_index(state.spo, state.epoch,
                                                  state.marked)


@register_auditable("snapshot", skip_passes=("NoArenaSort",))
def _audit_snapshot(engine, state):
    # the publication's one sort of the (p,o,s) keys, off the query path,
    # exempt like the index rebuild it mirrors
    clock = _StageClock(state.spo.device)
    yield "snapshot", lambda: _publish_snapshot(state.spo, state.sort_perm,
                                                state.sorted_keys, clock)
