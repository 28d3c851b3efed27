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
  * the host loop (``fuse_rounds=False``): :func:`process_candidates`, which
    reads the round's counts on the host and sizes the insertion by them,
    then the delta plans the fresh rows' resource masks allow.

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

The device work goes through the hand-written kernels
(:mod:`repro_torch.kernels.ops`): the stable dedup order, the sorted-key
search, the rho rewrite and the union-find.  Packed keys are native int64;
the reference's ``enable_x64`` scopes have no counterpart.  Unlike the
reference's pure functions, :func:`process_candidates` writes the fresh rows
into ``spo``/``epoch`` in place (the run owns its arena; a capacity restart
starts from a fresh one), saving an arena copy per round.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.merge import merge_sorted

from .materialise import Contradiction
from .rules import Program, Rule
from .stats import MatStats
from .terms import DIFFERENT_FROM, SAME_AS, is_var
from .triples import pack
from .uf import merge_pairs

I32 = torch.int32
I64 = torch.int64
KEY_MAX = (1 << 63) - 1  # > any packed key (IDs < 2^21 - 1)

# epoch predicates for matching in the forward rounds
PRED_OLD, PRED_DELTA, PRED_ALL = 0, 1, 2


class CapacityError(RuntimeError):
    """A static buffer overflowed; the message names the capacity to grow."""


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


def _epoch_ok(epoch, marked, r, pred: int) -> torch.Tensor:
    """Row-selection predicates of the forward rounds (``r`` an int or a 0-d
    tensor)."""
    live = (epoch >= 0) & ~marked
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


def build_plans(rule: Rule, full: bool) -> list[list[_AtomSpec]]:
    """Delta plans (or the single full-evaluation plan) of a rule."""
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
            count_appl = (pred == PRED_DELTA) or (full and j == 0)
            specs.append(_AtomSpec(j, const_mask, eq_pairs, b, f, pred, count_appl))
            bound |= {v for v, _ in b} | {v for v, _ in f}
        plans.append(specs)
    return plans


def _expand_join_index(cols, valid, spo, epoch, marked, r, sorted_keys,
                       sort_perm, consts, spec: _AtomSpec, k: int, comp: tuple,
                       out_cap: int):
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
    okr = _epoch_ok(epoch[srow], marked[srow], r, spec.pred)
    okr = _match_atom(rows, okr, consts, spec.const_mask, spec.eq_pairs)
    out_valid = out_valid & okr
    new_cols = {v: torch.where(out_valid, cols[v][seg], 0) for v in cols}
    for v, p in spec.free_items:
        new_cols[v] = torch.where(out_valid, rows[:, p], 0)
    return new_cols, out_valid, total > out_cap


def _join_step(cols, valid, spo, epoch, marked, r, sorted_keys, sort_perm,
               consts, spec: _AtomSpec, bind_cap: int):
    """One join step: prefix-key atoms whose predicate admits every live row
    (PRED_ALL) run as index range scans, the rest as the generic
    binding-sorting join.  Returns ``(cols, valid, overflow)``."""
    if spec.pred == PRED_ALL:
        k, comp = _index_prefix(spec)
        if k is not None:
            return _expand_join_index(
                cols, valid, spo, epoch, marked, r, sorted_keys, sort_perm,
                consts, spec, k, comp, bind_cap,
            )
    ok = _epoch_ok(epoch, marked, r, spec.pred)
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
              out_cap: int):
    """Evaluate one delta plan at round ``r`` (an int or a 0-d tensor).

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
            ok = _epoch_ok(epoch, marked, r, spec.pred)
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
                consts, spec, bind_cap,
            )
        overflow = overflow | ov
    out, out_valid, n_deriv, ov = _emit_heads(
        cols, valid, head_consts, head_var_slots, out_cap
    )
    return out, out_valid, n_deriv, n_appl, overflow, ov


def _squeeze_stream(cands, valid, target: int):
    """Compact a bucketed candidate stream to ``target`` rows (+ overflow)."""
    cols, v, ov = _compact(
        {"s": cands[:, 0], "p": cands[:, 1], "o": cands[:, 2]}, valid, target,
    )
    return torch.stack([cols["s"], cols["p"], cols["o"]], dim=1), v, ov


def _merge_round(rep, cands, cand_valid):
    """Steps 1-3 of a round: normalise the candidates with rho, merge their
    sameAs pairs (one union and one compression) and normalise again under
    the merged rho.  Returns ``(rep', cands', n_pairs)``."""
    cands, _ = ops.rewrite_triples(cands, rep, valid=cand_valid)
    is_pair = cand_valid & (cands[:, 1] == SAME_AS) & (cands[:, 0] != cands[:, 2])
    pairs = torch.stack([cands[:, 0], cands[:, 2]], dim=1)
    rep = merge_pairs(rep, pairs, is_pair)
    cands, _ = ops.rewrite_triples(cands, rep, valid=cand_valid)
    return rep, cands, is_pair.sum()


def _fresh_rows(all_c, all_v, sorted_keys):
    """Steps 5-8 of a round on the normalised candidates and swept rows:
    the contradiction check (~=5), the reflexive expansion (Algorithm 4
    lines 17-18: <c, sameAs, c> for each resource of each row, plus
    <sameAs, sameAs, sameAs>), the stable dedup order of the stream and
    its membership against the live rows through the persistent index.

    Returns ``(stream, order, sk, fresh, is_refl, contradiction)``: the
    stream's rows, their stable key order and the sorted keys, which sorted
    positions hold a fresh fact, which of those the reflexive expansion
    made (the stable order keeps a candidate occurrence of the same fact
    ahead of them), and the contradiction bit.  No host read."""
    dev = all_c.device
    C = sorted_keys.shape[0]
    contradiction = (
        all_v & (all_c[:, 1] == DIFFERENT_FROM) & (all_c[:, 0] == all_c[:, 2])
    ).any()
    res = all_c.reshape(-1)
    res_valid = all_v[:, None].expand(-1, 3).reshape(-1)
    refl = torch.stack([res, torch.full_like(res, SAME_AS), res], dim=1)
    sa_row = torch.full((1, 3), SAME_AS, dtype=I32, device=dev)
    stream = torch.cat([all_c, refl, sa_row], dim=0)
    stream_v = torch.cat([all_v, res_valid, all_v.any().reshape(1)], dim=0)
    skeys = torch.where(stream_v, _pack3(stream), KEY_MAX)
    order = ops.dedup_order(skeys).to(I64)
    sk = skeys[order]
    uniq = torch.ones_like(stream_v)
    uniq[1:] = sk[1:] != sk[:-1]
    uniq &= sk < KEY_MAX
    pos = ops.searchsorted(sorted_keys, sk, side="left").to(I64).clamp_(0, C - 1)
    fresh = uniq & (sorted_keys[pos] != sk)
    is_refl = fresh & (order >= all_c.shape[0])
    return stream, order, sk, fresh, is_refl, contradiction


def _read_now(fn):
    return fn()


def process_candidates(spo, epoch, marked, n_used, rep, sort_perm, sorted_keys,
                       cands, cand_valid, r: int, rewrite_cap: int,
                       delta_window: int = 4096, read=_read_now):
    """Normalise, merge equalities, sweep, insert — the state-update half of
    a round (Algorithms 3-6 in bulk).

    Returns ``(spo, epoch, marked, n_used, rep, sort_perm, sorted_keys,
    flags)``.  ``spo`` and ``epoch`` are updated in place.  ``flags`` holds
    Python values (``rep_changed``, ``contradiction``, ``ov_rewrite``,
    ``ov_store``, ``n_new``, ``n_pairs``, ``n_marked``, ``n_reflexive``) and
    ``delta_rows``, the first ``delta_window`` fresh rows in key order — the
    host derives the next round's plan-skipping masks from them.  On a store
    overflow nothing is inserted: the caller restarts the run.  ``read``
    makes the two host reads (:meth:`RoundLog.read` times and counts them).
    """
    dev = spo.device
    arena_cap = spo.shape[0] - 1  # last row is the trash slot
    C = sorted_keys.shape[0]

    # 1)-3) normalise, merge sameAs pairs, re-normalise under the new rho
    new_rep, cands, n_pairs = _merge_round(rep, cands, cand_valid)
    rep_changed = (new_rep != rep).any()
    rep = new_rep

    # 4) sweep the store (bulk Algorithm 3); quiet rounds skip the compaction
    rewritten, changed = ops.rewrite_triples(spo, rep, epoch=epoch, marked=marked)
    marked = marked | changed
    n_marked = read(lambda: int(changed.sum()))
    if n_marked:
        rw_cols, rw_valid, rw_overflow = _compact(
            {"s": rewritten[:, 0], "p": rewritten[:, 1], "o": rewritten[:, 2]},
            changed, rewrite_cap,
        )
        rw = torch.stack([rw_cols["s"], rw_cols["p"], rw_cols["o"]], dim=1)
        sort_perm, sorted_keys = _index_remove(sort_perm, sorted_keys, changed,
                                               arena_cap)
    else:
        rw = torch.zeros((rewrite_cap, 3), dtype=I32, device=dev)
        rw_valid = torch.zeros(rewrite_cap, dtype=torch.bool, device=dev)
        rw_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    all_c = torch.cat([cands, rw], dim=0)
    all_v = torch.cat([cand_valid, rw_valid], dim=0)

    # 5)-8) contradiction check, reflexivity, dedup, membership
    stream, order, sk, fresh, is_refl, contradiction = _fresh_rows(
        all_c, all_v, sorted_keys)

    # the host reads every scalar of the round in one transfer
    (n_fresh, n_refl, n_used_h, n_pairs, rep_changed, contradiction,
     rw_overflow) = read(torch.stack([
        fresh.sum(), is_refl.sum(), n_used.reshape(()).to(I64), n_pairs,
        rep_changed.to(I64), contradiction.to(I64), rw_overflow.to(I64),
    ]).tolist)
    insert_overflow = n_used_h + n_fresh > arena_cap

    # 9) write the fresh rows into free slots and rank-merge them, already
    # in key order, into the persistent index
    d_rows = torch.zeros((0, 3), dtype=I32, device=dev)
    if n_fresh and not insert_overflow:
        slot = n_used_h + torch.cumsum(fresh, 0) - 1
        d, _, _ = _compact(
            {"k": sk, "v": slot.to(I32), "row": order}, fresh, n_fresh
        )
        d_rows = stream[d["row"]]
        tgt = d["v"].to(I64)
        spo[tgt] = d_rows
        epoch[tgt] = r
        sorted_keys, sort_perm = merge_sorted(
            sorted_keys, sort_perm, d["k"], d["v"], out_len=C
        )
        n_used = n_used + n_fresh

    flags = {
        "rep_changed": bool(rep_changed),
        "contradiction": bool(contradiction),
        "ov_rewrite": bool(rw_overflow),
        "ov_store": insert_overflow,
        "n_new": n_fresh,
        "n_pairs": n_pairs,
        "n_marked": n_marked,
        "n_reflexive": n_refl,
        "delta_rows": d_rows[:delta_window],
    }
    return spo, epoch, marked, n_used, rep, sort_perm, sorted_keys, flags


def process_static(spo, epoch, marked, n_used, rep, sort_perm, sorted_keys,
                   cands, cand_valid, r, rewrite_cap: int):
    """:func:`process_candidates` at static shapes, with no host read: the
    state update of one round of the fused loop (the reference's
    ``process_candidates``, which the fused ``lax.while_loop`` inlines).

    ``r`` is a 0-d int32 tensor.  Every shape depends on the capacities
    alone and nothing waits on the device, so the same calls can be
    captured once into a CUDA graph and replayed round after round:

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

    ``epoch`` is updated in place and ``spo`` too, as in
    :func:`process_candidates`; the rest comes back new.  Returns ``(spo,
    epoch, marked, n_used, rep, sort_perm, sorted_keys, flags)`` with
    ``flags`` the tensors ``contradiction``, ``ov_rewrite``, ``ov_store``,
    ``n_new``, ``n_pairs`` and ``n_reflexive``.  On a store overflow the
    arena holds garbage: the caller restarts the run.
    """
    dev = spo.device
    arena_cap = spo.shape[0] - 1  # last row is the trash slot
    C = sorted_keys.shape[0]

    # 1)-3) normalise, merge sameAs pairs, re-normalise under the new rho
    rep, cands, n_pairs = _merge_round(rep, cands, cand_valid)

    # 4) sweep the store, every round
    rewritten, changed = ops.rewrite_triples(spo, rep, epoch=epoch, marked=marked)
    marked = marked | changed
    rw_cols, rw_valid, rw_overflow = _compact(
        {"s": rewritten[:, 0], "p": rewritten[:, 1], "o": rewritten[:, 2]},
        changed, rewrite_cap,
    )
    rw = torch.stack([rw_cols["s"], rw_cols["p"], rw_cols["o"]], dim=1)
    sort_perm, sorted_keys = _index_remove(sort_perm, sorted_keys, changed,
                                           arena_cap)
    all_c = torch.cat([cands, rw], dim=0)
    all_v = torch.cat([cand_valid, rw_valid], dim=0)

    # 5)-8) contradiction check, reflexivity, dedup, membership
    stream, order, sk, fresh, is_refl, contradiction = _fresh_rows(
        all_c, all_v, sorted_keys)
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
        "n_new": n_fresh,
        "n_pairs": n_pairs,
        "n_reflexive": n_refl,
    }
    return spo, epoch, marked, n_used, rep, sort_perm, sorted_keys, flags


def index_invariant_report(state: "EngineState") -> list[str]:
    """Violations of the persistent-index invariant (empty == healthy).

    ``sorted_keys`` must hold exactly the packed keys of the live rows,
    ascending, followed by KEY_MAX padding, and ``sort_perm``'s prefix must
    enumerate exactly those rows.
    """
    probs: list[str] = []
    spo = state.spo.cpu().numpy()
    live = (state.epoch.cpu().numpy() >= 0) & ~state.marked.cpu().numpy()
    keys = state.sorted_keys.cpu().numpy()
    perm = state.sort_perm.cpu().numpy()
    want = np.sort(pack(spo[live]))
    n = want.shape[0]
    if not (keys[n:] == KEY_MAX).all():
        probs.append("non-sentinel entries beyond live prefix")
    if not np.array_equal(keys[:n], want):
        probs.append("sorted_keys != sort(pack3(live rows))")
    if not np.array_equal(np.sort(perm[:n]), np.flatnonzero(live)):
        probs.append("sort_perm prefix is not the live row set")
    if not np.array_equal(pack(spo[perm[:n]]), keys[:n]):
        probs.append("sort_perm rows disagree with sorted_keys")
    return probs


_STATE_ARRAYS = {
    "spo": I32, "epoch": I32, "marked": torch.bool, "tomb": I32,
    "n_used": I32, "rep": I32, "sort_perm": I32, "sorted_keys": I64,
}


@dataclass
class EngineState:
    """Materialisation state on one device.

    ``sort_perm``/``sorted_keys`` is the persistent sorted arena index: the
    packed int64 keys of exactly the live (``epoch >= 0 & ~marked``) rows in
    ascending order, KEY_MAX padding behind, and each entry's arena row.
    ``tomb`` is the incremental delete path's tombstone column (-1 = live),
    carried for state exchange with the reference; the base run never sets
    it.  ``r`` is the running round counter.
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

    @property
    def n_res(self) -> int:
        return int(self.rep.shape[0])


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
    """The wall split of one ``materialise_state`` call (host clock).

    ``setup_s`` runs from the entry to the first round; each round records
    its wall, the time the host spent blocked on the device inside it
    (:meth:`read` synchronises before it reads) and its host reads; the
    time between rounds (a fused loop's exit handling) goes to
    ``between_s``, and the rest after the last round to ``stats_s``.  A
    round's wall less its wait is the host's time in it: launching its work
    and everything else on the host.  A capacity restart starts a new log.
    """

    def __init__(self, device: torch.device) -> None:
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.t0 = time.perf_counter()
        self.setup_s: float | None = None
        self.rounds: list[dict] = []
        self.between_s = 0.0
        self.stats_s = 0.0
        self.reads = 0  # reads outside rounds
        self._t: float | None = None
        self._end: float | None = None
        self._wait = 0.0
        self._reads = 0

    def begin_round(self) -> None:
        now = time.perf_counter()
        if self.setup_s is None:
            self.setup_s = now - self.t0
        elif self._end is not None:
            self.between_s += now - self._end
        self._t, self._wait, self._reads = now, 0.0, 0

    def read(self, fn):
        """``fn()`` after the device has caught up; timed and counted."""
        t = time.perf_counter()
        if self.stream is not None:
            self.stream.synchronize()
        if self._t is None:
            self.reads += 1
        else:
            self._wait += time.perf_counter() - t
            self._reads += 1
        return fn()

    def end_round(self) -> None:
        self._end = time.perf_counter()
        self.rounds.append(dict(wall_s=self._end - self._t, wait_s=self._wait,
                                reads=self._reads))
        self._t = None

    def finish(self) -> dict:
        """The split as a dict, the stats time counted from the last round."""
        now = time.perf_counter()
        if self.setup_s is None:
            self.setup_s = now - self.t0
        self.stats_s = now - (self._end if self._end is not None
                              else self.t0 + self.setup_s)
        return dict(
            setup_s=self.setup_s,
            rounds=self.rounds,
            between_s=self.between_s,
            stats_s=self.stats_s,
            wall_s=now - self.t0,
            reads=sum(r["reads"] for r in self.rounds) + self.reads,
        )


class TorchEngine:
    """REW materialisation with static capacities on one device.

    Runs on the card unless the caller passes ``device="cpu"``; with no card
    and no explicit CPU device, construction raises.  ``materialise``
    restarts with the exhausted capacity doubled on overflow, so callers
    normally never see :class:`CapacityError`.

    ``fuse_rounds`` (default True, as the reference's) runs the rounds at
    the stream width through the fused loop (:mod:`repro_torch.core.fused`);
    False keeps the host loop.  On the card the fused round is one replay
    of a captured CUDA graph, and the engine keeps the graph of its last
    key across calls; on the CPU the same body runs eagerly.
    ``last_split`` holds the last call's :class:`RoundLog` split.
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
    ) -> None:
        self.device = resolve(device, "TorchEngine")
        self.n_resources = n_resources
        self.capacity = capacity
        self.bind_cap = bind_cap
        self.out_cap = out_cap
        self.rewrite_cap = rewrite_cap
        # bounded per-round window of fresh rows the host reads back for the
        # next round's plan-skipping masks; rounds that insert more fall back
        # to all-True masks (sound, unfiltered; stats.delta_mask_fallbacks)
        self.delta_window = delta_window
        self.fuse_rounds = fuse_rounds
        self._graph = None  # fused.RoundGraph of the last key
        self._tables: tuple | None = None  # (program, device constant tables)
        self.last_split: dict | None = None
        self._log = RoundLog(self.device)

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
            stats=MatStats(mode="REW-torch"),
        )

    def _pad_cands(self, rows: np.ndarray):
        """Pad a host candidate batch to the candidate stream width."""
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        if rows.shape[0] > self.out_cap:
            raise CapacityError("out")
        cands = torch.zeros((self.out_cap, 3), dtype=I32, device=self.device)
        cands[: rows.shape[0]] = torch.from_numpy(rows).to(self.device)
        cand_valid = torch.arange(self.out_cap, device=self.device) < rows.shape[0]
        return cands, cand_valid

    @staticmethod
    def _count_distinct(cands, cand_valid) -> torch.Tensor:
        """Distinct valid rows of a padded stream, on its device: the stable
        dedup order of the packed keys, then the first of each run."""
        keys = torch.where(cand_valid, _pack3(cands), KEY_MAX)
        sk = keys[ops.dedup_order(keys).to(I64)]
        first = torch.ones_like(cand_valid)
        first[1:] = sk[1:] != sk[:-1]
        return (first & (sk < KEY_MAX)).sum()

    def _grow_for(self, kind: str) -> None:
        """Double exactly the capacity a :class:`CapacityError` names."""
        attr = {"store": "capacity", "bind": "bind_cap", "out": "out_cap",
                "rewrite": "rewrite_cap"}[kind]
        setattr(self, attr, getattr(self, attr) * 2)

    def _bucket_cands(self, bufs):
        """Concatenate plan output buffers, padding each width group with
        empty buffers to a power-of-two count (the reference's bucketing,
        kept so the candidate stream has the same rows in the same order)."""
        groups: dict[int, list] = {}
        for b in bufs:
            groups.setdefault(int(b[0].shape[0]), []).append(b)
        heads, valids = [], []
        for rows, bs in sorted(groups.items()):
            total = 1
            while total < len(bs):
                total *= 2
            pad = total - len(bs)
            heads += [b[0] for b in bs]
            valids += [b[1] for b in bs]
            if pad:
                heads.append(torch.zeros((rows * pad, 3), dtype=I32,
                                         device=self.device))
                valids.append(torch.zeros(rows * pad, dtype=torch.bool,
                                          device=self.device))
        return torch.cat(heads, dim=0), torch.cat(valids, dim=0)

    def _refresh_stats(self, state: EngineState) -> None:
        stats = state.stats
        stats.triples_total = int(state.n_used.sum())
        stats.merged_resources = int(
            (self.state_rep(state) != np.arange(state.n_res)).sum()
        )

    def state_triples(self, state: EngineState) -> np.ndarray:
        """The current normal-form store as a host (n, 3) array."""
        live = (state.epoch >= 0) & ~state.marked
        state.stats.triples_unmarked = int(live.sum())
        return state.spo[live].cpu().numpy()

    def state_rep(self, state: EngineState) -> np.ndarray:
        """rho on the host; ``merge_pairs`` leaves it compressed."""
        return state.rep.to("cpu", copy=True).numpy()

    def _rewrite_program(self, state: EngineState, stats: MatStats) -> list[int]:
        """Rewrite the program under the current rho; every changed rule is
        requeued for full evaluation (Algorithm 1 lines 6-9)."""
        rep = self._log.read(lambda: self.state_rep(state))
        p_new, changed_idx = state.program.rewrite(rep)
        if changed_idx:
            stats.rule_rewrites += 1
            stats.rules_requeued += len(changed_idx)
        state.program = p_new
        return changed_idx

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

    def _eval_rule(self, state: EngineState, r: int, k: int, mode: str,
                   stats: MatStats, delta_masks: np.ndarray | None = None):
        """Evaluate the plans of rule ``k``; ``mode`` is "delta" or "full".
        ``delta_masks`` (3, n_res) skips delta plans whose delta atom cannot
        match the current delta."""
        rule = state.program.rules[k]
        atom_consts, head_consts = self._program_tables(state.program)
        head_slots = tuple(t if is_var(t) else None for t in rule.head)
        full = mode == "full"
        out = []
        for i, plan in enumerate(build_plans(rule, full=full)):
            if (
                delta_masks is not None
                and not full
                and not self._atom_may_match(rule.body[i], delta_masks)
            ):
                continue
            heads, valid, n_d, n_a, ov_bind, ov_out = eval_plan(
                state.spo, state.epoch, state.marked, state.sorted_keys,
                state.sort_perm, r, atom_consts[k], head_consts[k],
                tuple(plan), head_slots, self.bind_cap, self.out_cap,
            )
            n_d, n_a, ov_bind, ov_out = self._log.read(torch.stack(
                [n_d.to(I64), n_a, ov_bind.to(I64), ov_out.to(I64)]
            ).tolist)
            if ov_bind:
                raise CapacityError("bind")
            if ov_out:
                raise CapacityError("out")
            stats.derivations += n_d
            stats.rule_applications += n_a
            if full:
                stats.full_plan_evals += 1
            out.append((heads, valid))
        return out

    def _stream_of(self, bufs):
        """The next round's stream from plan buffers: bucketed, squeezed to
        ``out_cap`` when wider.  Returns ``(cands, cand_valid, have_cands)``."""
        cands, cand_valid = self._bucket_cands(bufs)
        if cands.shape[0] > self.out_cap:
            cands, cand_valid, sq_ov = _squeeze_stream(
                cands, cand_valid, self.out_cap
            )
            if self._log.read(lambda: bool(sq_ov)):
                raise CapacityError("out")
        return cands, cand_valid, self._log.read(lambda: bool(cand_valid.any()))

    # -- driver --------------------------------------------------------------
    def _forward(self, state: EngineState, cands, cand_valid,
                 max_rounds: int) -> None:
        """The bulk-synchronous round loop, from ``state`` to the fixpoint.

        As the reference's: with ``fuse_rounds``, a stream at the ``out_cap``
        width with no rule awaiting full evaluation runs through the fused
        loop (:meth:`_fused_forward`); any other round is a host round.
        """
        stats = state.stats
        log = self._log
        requeued: list[int] = []
        rounds_here = 0
        have_cands = True
        while have_cands or requeued:
            if (self.fuse_rounds and not requeued
                    and cands.shape[0] == self.out_cap):
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
            (state.spo, state.epoch, state.marked, state.n_used, state.rep,
             state.sort_perm, state.sorted_keys, flags) = process_candidates(
                state.spo, state.epoch, state.marked, state.n_used, state.rep,
                state.sort_perm, state.sorted_keys, cands, cand_valid, r,
                self.rewrite_cap, self.delta_window, read=log.read,
            )
            if flags["ov_store"]:
                raise CapacityError("store")
            if flags["ov_rewrite"]:
                raise CapacityError("rewrite")
            if flags["contradiction"]:
                raise Contradiction("owl:differentFrom violation")
            stats.sameas_pairs += flags["n_pairs"]
            stats.reflexive_added += flags["n_reflexive"]
            stats.derivations += flags["n_reflexive"]
            if flags["rep_changed"]:
                requeued.extend(self._rewrite_program(state, stats))

            # evaluate plans for the new delta, skipping plans whose delta
            # atom is incompatible with the fresh rows' resource masks
            bufs = []
            n_new = flags["n_new"]
            if n_new > 0:
                d_rows = log.read(flags["delta_rows"].cpu().numpy)
                if d_rows.shape[0] < n_new:
                    stats.delta_mask_fallbacks += 1
                    delta_masks = np.ones((3, state.n_res), dtype=bool)
                else:
                    delta_masks = np.zeros((3, state.n_res), dtype=bool)
                    for pos in range(3):
                        delta_masks[pos][d_rows[:, pos]] = True
                for k in range(len(state.program.rules)):
                    bufs += self._eval_rule(state, r + 1, k, "delta", stats,
                                            delta_masks=delta_masks)
            for k in sorted(set(requeued)):
                bufs += self._eval_rule(state, r + 1, k, "full", stats)
            requeued = []
            if not bufs:
                have_cands = False
            else:
                cands, cand_valid, have_cands = self._stream_of(bufs)
            log.end_round()

    def _round_graph(self, state: EngineState, cands, cand_valid, plans):
        """The engine's captured round for this key, made anew (and the old
        one freed, with its memory pool) when the key changed."""
        from .fused import RoundGraph

        key = (int(cands.shape[0]), plans, self.capacity, self.bind_cap,
               self.out_cap, self.rewrite_cap, state.n_res)
        if self._graph is not None and self._graph.key != key:
            self._graph = None
            torch.cuda.empty_cache()
        if self._graph is None:
            self._graph = RoundGraph(
                key, state, cands, cand_valid, plans,
                dict(rewrite_cap=self.rewrite_cap, bind_cap=self.bind_cap,
                     plan_out_cap=self.out_cap),
            )
        return self._graph

    def _fused_forward(self, state: EngineState, cands, cand_valid,
                       rounds_left: int):
        """Run forward rounds through the fused loop.

        Returns ``(iters, cands, cand_valid, have_cands)``.  Convergence
        returns an empty stream; a rho-reaches-a-rule-constant exit rewrites
        the program, evaluates the exit round's delta plans (the loop
        nullified its own evaluation of that round) and the requeued rules'
        full plans on the host, and hands the stream back to the round
        loop.  Overflow and contradiction raise what the host loop raises.
        """
        from .fused import forward_plan_signature, fused_forward_rounds

        stats = state.stats
        plans = forward_plan_signature(state.program)
        graph = (self._round_graph(state, cands, cand_valid, plans)
                 if self.device.type == "cuda" else None)
        cands, cand_valid, fl = fused_forward_rounds(
            state, cands, cand_valid, rounds_left, plans=plans,
            rewrite_cap=self.rewrite_cap, bind_cap=self.bind_cap,
            plan_out_cap=self.out_cap, log=self._log, graph=graph,
        )
        iters = fl["iters"]
        state.r += iters
        stats.rounds += iters
        stats.sameas_pairs += fl["n_pairs"]
        stats.reflexive_added += fl["n_reflexive"]
        stats.derivations += fl["n_reflexive"] + fl["n_deriv"]
        stats.rule_applications += fl["n_appl"]
        if fl["ov_store"]:
            raise CapacityError("store")
        if fl["ov_rewrite"]:
            raise CapacityError("rewrite")
        if fl["contradiction"]:
            raise Contradiction("owl:differentFrom violation")
        if fl["ov_bind"]:
            raise CapacityError("bind")
        if fl["ov_out"] or fl["ov_squeeze"]:
            raise CapacityError("out")
        if fl["consts_changed"]:
            full_q = self._rewrite_program(state, stats)
            r = state.r
            bufs = []
            if fl["n_new"] > 0:
                # the exit round's fresh rows are in the store, but no delta
                # mask was made of them: every delta plan runs (a plan that
                # could have been skipped matches no row and counts nothing)
                for k in range(len(state.program.rules)):
                    bufs += self._eval_rule(state, r + 1, k, "delta", stats)
            for k in sorted(set(full_q)):
                bufs += self._eval_rule(state, r + 1, k, "full", stats)
            if bufs:
                cands, cand_valid, have_cands = self._stream_of(bufs)
                return iters, cands, cand_valid, have_cands
            return iters, cands, cand_valid, False
        if fl["have_cands"]:
            raise RuntimeError("did not converge")
        return iters, cands, cand_valid, False

    # -- public API ----------------------------------------------------------
    def materialise_state(self, facts, program: Program,
                          max_rounds: int = 10_000) -> EngineState:
        """Base REW fixpoint, restarting with grown capacities on overflow.
        ``triples_explicit`` counts the distinct facts on the device."""
        t0 = time.perf_counter()
        facts = np.asarray(facts, np.int32).reshape(-1, 3)
        restarts = 0
        while True:
            self._log = RoundLog(self.device)
            try:
                state = self._fresh_state(program)
                cands, cand_valid = self._pad_cands(facts)
                n_explicit = self._count_distinct(cands, cand_valid)
                self._forward(state, cands, cand_valid, max_rounds)
                break
            except CapacityError as e:
                self._grow_for(str(e))
                restarts += 1
        state.stats.capacity_retries = restarts
        state.stats.triples_explicit = self._log.read(lambda: int(n_explicit))
        self._refresh_stats(state)
        state.stats.wall_seconds += time.perf_counter() - t0
        self.last_split = self._log.finish()
        if self._graph is not None:
            self.last_split["capture_s"] = self._graph.capture_s
        return state

    def materialise(self, facts, program: Program, max_rounds: int = 10_000):
        """REW materialisation: ``(live triples, compressed rho, stats)``."""
        state = self.materialise_state(facts, program, max_rounds)
        return self.state_triples(state), self.state_rep(state), state.stats
