"""Incremental maintenance on the device: add and delete, on one device.

The single-device counterpart of ``repro.core.incremental_spmd`` (the name
is kept so a reader finds it; there is no sharding here: the reference's
owner routing ``_route_rows`` is the identity on one device, and its psums
are nothing).  :class:`repro_torch.core.engine.TorchEngine` drives it
through :meth:`~repro_torch.core.engine.TorchEngine.add_facts` and
:meth:`~repro_torch.core.engine.TorchEngine.delete_facts`.

**Additions** reuse the engine's forward round loop: the delta batch is the
candidate stream of the next round, at the next epoch.

**Deletions** are DRed's backward/forward pass with the backward closure on
the device as epoch-tagged tombstones:

1. *Seed*: the rho normal forms of the deleted explicit triples (through
   ``rewrite_owner``) tag their store rows ``tomb = 0``.
2. *Overdelete waves*: wave ``w`` evaluates every rule's tombstone plans
   (Delta = rows with ``tomb == w-1``, every other atom the whole
   pre-deletion store), then :func:`_od_step` tags the derived heads, the
   reflexivity children of the wave's frontier, and every row touching a
   freshly *suspect* clique (one whose reflexive witness was tagged).
3. *Finalize*: tombstones become ``marked``, leave the sorted index, and
   ``tomb`` returns to -1.
4. *Split and rederive*: suspect cliques revert to singletons, the base
   program is rewritten under the split rho, and targeted rederivation
   binds each candidate rule's head to the overdeleted instances and joins
   its body backward through the index.  The restored instances, the
   explicit triples whose normal form went missing and the missing
   reflexive witnesses of surviving resources seed the forward loop.

The explicit set lives on the device as sorted distinct packed keys, and
every membership query of the delete path (seed, member, occupancy) is one
call on a batch padded to a multiple of ``engine.seed_chunk``, read once.
Scatters of the reference that drop out-of-range targets are masked writes
here (:func:`_mark`).

After any update sequence the state equals the from-scratch REW
materialisation of the updated explicit set: the same rho and normal-form
store (``tests/test_torch_incremental*.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.merge import merge_sorted

from .engine import (
    I32,
    I64,
    KEY_MAX,
    CapacityError,
    EngineState,
    _compact,
    _index_remove,
    _pack3,
    _pow2,
    _squeeze_stream,
    _unpack3,
)
from .terms import SAME_AS, is_var
from .triples import dedup_rows, pack

__all__ = [
    "spmd_add_facts",
    "spmd_add_phases",
    "spmd_delete_facts",
    "spmd_delete_phases",
]


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def _mark(n: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool, True at ``idx[i]`` for every ``i`` with ``mask[i]``: the
    reference's ``zeros(n).at[where(mask, idx, x)].max(mask)`` and its
    dropped scatters.  Masked-out rows add 0 at spread targets, so nothing
    is written out of range and no one address takes every write."""
    spread = torch.arange(idx.shape[0], device=idx.device) % n
    tgt = torch.where(mask, idx.to(I64), spread)
    count = torch.zeros(n, dtype=I32, device=idx.device)
    count.index_add_(0, tgt, mask.to(I32))
    return count > 0


def _probe_index(sorted_keys, sort_perm, select, queries, qvalid):
    """Arena row of each query triple among the ``select``-ed live rows,
    through the sorted index: ``(rows, hit)``, rows garbage where not hit
    (live keys are unique, so at most one entry matches a query)."""
    qk = _pack3(queries)
    pos = ops.searchsorted(sorted_keys, qk, side="left").to(I64)
    pos = pos.clamp_(0, sorted_keys.shape[0] - 1)
    rows = sort_perm[pos].to(I64)
    hit = (sorted_keys[pos] == qk) & qvalid & select[rows]
    return rows, hit


def _seed_tombs(sorted_keys, sort_perm, epoch, marked, tomb, q, qv):
    """Tag wave-0 tombstones: the untagged live rows matching the queries.
    Returns ``(tomb', n_tagged)``."""
    untagged = (epoch >= 0) & ~marked & (tomb < 0)
    rows, hit = _probe_index(sorted_keys, sort_perm, untagged, q, qv)
    tomb = torch.where(_mark(tomb.shape[0], rows, hit), 0, tomb)
    return tomb, hit.sum()


def _normalise(rows, rep, valid):
    """``where(valid, rep[rows], 0)`` through the rewrite kernel."""
    if rows.shape[0] == 0:
        return rows
    out, _changed = ops.rewrite_triples(rows, rep, valid=valid)
    return out


def _od_step(spo, epoch, marked, tomb, sorted_keys, sort_perm, rep, sizes,
             suspect, heads, hv, w, *, refl_cap: int, with_masks: bool = True):
    """One overdelete wave after its tombstone plans: tag the normalised
    heads and the reflexivity children of the frontier, find the suspect
    cliques (a tagged reflexive witness of a clique of more than one
    member) and grab every live row touching a fresh suspect.  Returns
    ``(tomb', suspect', n_new, route_overflow, refl_overflow, masks)``;
    ``masks`` (3, n_res) are the per-position resource masks of the wave's
    new rows (all False with ``with_masks=False``, as the fused loop needs
    none).  ``w`` is an int or a 0-d tensor; no host read."""
    C = spo.shape[0]
    n_res = rep.shape[0]
    dev = spo.device
    store = (epoch >= 0) & ~marked  # the pre-deletion store (DRed's T)
    frontier = store & (tomb == w - 1)

    heads_n = _normalise(heads, rep, hv)

    # reflexivity children <c, sameAs, c> of every resource of the
    # compacted frontier, and the sameAs row itself
    fcols, fvalid, f_ov = _compact(
        {"s": spo[:, 0], "p": spo[:, 1], "o": spo[:, 2]}, frontier, refl_cap)
    f_spo = torch.stack([fcols["s"], fcols["p"], fcols["o"]], dim=1)
    res = f_spo.reshape(-1)
    res_v = fvalid[:, None].expand(-1, 3).reshape(-1)
    refl = torch.stack([res, torch.full_like(res, SAME_AS), res], dim=1)
    sa_row = torch.full((1, 3), SAME_AS, dtype=I32, device=dev)
    stream = torch.cat([heads_n, refl, sa_row], dim=0)
    sv = torch.cat([hv, res_v, frontier.any().reshape(1)], dim=0)

    # dedup the stream (the stable dedup order of its keys)
    keys = torch.where(sv, _pack3(stream), KEY_MAX)
    order = ops.dedup_order(keys).to(I64)
    sk = keys[order]
    uniq = torch.ones_like(sv)
    uniq[1:] = sk[1:] != sk[:-1]
    stream, sv = stream[order], uniq & (sk < KEY_MAX)

    # tag the matching untagged live rows (tagging changes no liveness,
    # so the index stays exact across the whole backward pass)
    rows, hit = _probe_index(sorted_keys, sort_perm, store & (tomb < 0),
                             stream, sv)
    tomb = torch.where(_mark(C, rows, hit), w, tomb)

    # suspect cliques, from this wave's new rows and its frontier
    wit = store & ((tomb == w) | (tomb == w - 1))
    s0 = spo[:, 0].to(I64)
    is_wit = (wit & (spo[:, 1] == SAME_AS) & (spo[:, 0] == spo[:, 2])
              & (sizes[s0] > 1))
    cand = _mark(n_res, s0, is_wit)
    fresh = cand & ~suspect
    suspect = suspect | cand

    # grab every live row touching a fresh suspect
    touch = (fresh[s0] | fresh[spo[:, 1].to(I64)] | fresh[spo[:, 2].to(I64)])
    tomb = torch.where(store & (tomb < 0) & touch, w, tomb)

    new = store & (tomb == w)
    if with_masks:
        masks = torch.stack([_mark(n_res, spo[:, pos], new) for pos in range(3)])
    else:
        masks = torch.zeros((3, n_res), dtype=torch.bool, device=dev)
    no_route = torch.zeros((), dtype=torch.bool, device=dev)
    return tomb, suspect, new.sum(), no_route, f_ov, masks


def _finalize_tombs(spo, epoch, marked, tomb, sorted_keys, sort_perm, rep):
    """Tombstones become the outdated bit and leave the index (a stable
    partition); ``tomb`` returns to -1.  Returns ``(marked, tomb,
    sorted_keys, sort_perm, od_mask (3, n_res), n_od)``, ``od_mask`` the
    per-position masks of the overdeleted rows (the rederive filter)."""
    tombed = tomb >= 0
    od_mask = torch.stack([_mark(rep.shape[0], spo[:, pos], tombed)
                           for pos in range(3)])
    n_od = tombed.sum()
    marked = marked | tombed
    tomb = torch.full_like(tomb, -1)
    sort_perm, sorted_keys = _index_remove(sort_perm, sorted_keys, tombed,
                                           spo.shape[0] - 1)
    return marked, tomb, sorted_keys, sort_perm, od_mask, n_od


def _extract_tombed(spo, tomb, cap: int):
    """The overdeleted rows (``tomb >= 0``), compacted to ``cap``: the
    tombstone set that drives targeted rederivation (before finalize)."""
    cols, valid, ov = _compact(
        {"s": spo[:, 0], "p": spo[:, 1], "o": spo[:, 2]}, tomb >= 0, cap)
    return torch.stack([cols["s"], cols["p"], cols["o"]], dim=1), valid, ov


def _member(sorted_keys, q, qv):
    """Membership of query triples among the live rows: the index holds
    exactly them, so a key hit is liveness.  KEY_MAX is the padding."""
    qk = _pack3(q)
    pos = ops.searchsorted(sorted_keys, qk, side="left").to(I64)
    pos = pos.clamp_(0, sorted_keys.shape[0] - 1)
    return (sorted_keys[pos] == qk) & qv & (qk < KEY_MAX)


def _occupancy(spo, epoch, marked, rep):
    """Mask of the resources occurring in live rows."""
    live = (epoch >= 0) & ~marked
    return _mark(rep.shape[0], spo.reshape(-1),
                 live[:, None].expand(-1, 3).reshape(-1))


def _keys_in(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Which ``keys`` occur in the sorted (distinct) ``sorted_keys``."""
    if sorted_keys.shape[0] == 0 or keys.shape[0] == 0:
        return torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    pos = ops.searchsorted(sorted_keys, keys, side="left").to(I64)
    pos = pos.clamp_(0, sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == keys


def _merge_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rank-merge of two sorted key columns."""
    if a.shape[0] == 0:
        return b
    return merge_sorted(a, a, b, b, a.shape[0] + b.shape[0])[0]


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def _padded(engine, rows: torch.Tensor):
    """A query batch on the device padded with invalid rows to a multiple
    of ``engine.seed_chunk``: ``(queries, valid)``."""
    n = rows.shape[0]
    width = max(-(-n // engine.seed_chunk), 1) * engine.seed_chunk
    q = torch.zeros((width, 3), dtype=I32, device=rows.device)
    q[:n] = rows
    return q, torch.arange(width, device=rows.device) < n


def _member_query(engine, state: EngineState, rows: torch.Tensor) -> torch.Tensor:
    """Membership of device ``rows`` among the live rows: one call."""
    q, qv = _padded(engine, rows)
    return _member(state.sorted_keys, q, qv)[: rows.shape[0]]


def _tomb_heads(engine, state: EngineState, w: int, masks: np.ndarray):
    """The tombstone plans of wave ``w`` (skipping plans whose delta atom
    misses the frontier's ``masks``), bucketed and squeezed to the active
    delta width.  Counts nothing."""
    bufs = []
    for k in range(len(state.program.rules)):
        bufs += engine._eval_rule(state, w, k, "tomb", None, delta_masks=masks)
    if not bufs:
        dev = engine.device
        return (torch.zeros((0, 3), dtype=I32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    heads, hv = engine._bucket_cands(bufs)
    if heads.shape[0] > engine._active_delta_out:
        heads, hv, sq_ov = _squeeze_stream(heads, hv, engine._active_delta_out)
        if engine._log.read(lambda: bool(sq_ov)):
            raise CapacityError(engine._active_delta_kind)
    return heads, hv


def _head_may_rederive(rule, od_mask: np.ndarray, rep_old: np.ndarray) -> bool:
    """False iff no overdeleted row can match the rule's head pattern (head
    constants through the pre-deletion rho, under which the rows were
    normal)."""
    for pos, t in enumerate(rule.head):
        if not is_var(t) and not od_mask[pos][rep_old[t]]:
            return False
    return True


def _head_bindings(rule, od_rows: np.ndarray, rep_old: np.ndarray):
    """The distinct head-variable bindings of the overdeleted rows that
    match ``rule``'s head (constants through the pre-deletion rho), in the
    head's first-occurrence variable order; ``None`` for a ground head."""
    m = np.ones(od_rows.shape[0], dtype=bool)
    first: dict[int, int] = {}
    for pos, t in enumerate(rule.head):
        if is_var(t):
            if t in first:
                m &= od_rows[:, pos] == od_rows[:, first[t]]
            else:
                first[t] = pos
        else:
            m &= od_rows[:, pos] == rep_old[t]
    if not first:
        return None
    cols = [od_rows[m, pos] for pos in first.values()]
    return np.unique(np.stack(cols, axis=1), axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# the phase generators
# ---------------------------------------------------------------------------

def spmd_add_phases(engine, state: EngineState, delta, max_rounds: int):
    """Phase generator behind :func:`spmd_add_facts`: yields ``"prepared"``
    after the explicit-set bookkeeping, then runs the forward fixpoint.
    A driver exhausts it or rolls the state back to a snapshot taken
    before it started (``TorchEngine._snapshot``).  A no-effect delta
    yields nothing."""
    engine._ensure_index(state)
    delta = dedup_rows(delta)
    if delta.shape[0]:
        dk = torch.from_numpy(pack(delta)).to(engine.device)
        known = engine._log.read(lambda: _keys_in(state.explicit, dk).cpu().numpy())
        delta = delta[~known]
    if delta.shape[0] == 0:
        return
    engine._grow_rep(state, int(delta.max()) + 1)
    state.explicit = _merge_keys(
        state.explicit, torch.from_numpy(np.sort(pack(delta))).to(engine.device))
    state.stats.triples_explicit = int(state.explicit.shape[0])
    engine._presize_delta(delta.shape[0])
    cands, cand_valid = engine._pad_cands(delta)
    yield "prepared"
    engine._forward(state, cands, cand_valid, [], max_rounds)


def spmd_add_facts(engine, state: EngineState, delta, max_rounds: int) -> EngineState:
    """Additions: seed the engine's forward loop with the fresh triples."""
    for _phase in spmd_add_phases(engine, state, delta, max_rounds):
        pass
    return state


def spmd_delete_phases(engine, state: EngineState, delta, max_rounds: int):
    """Phase generator behind :func:`spmd_delete_facts`, with the
    reference's labels in its order: ``"seeded"`` (wave-0 tombstones
    tagged), ``"wave"`` (after each host-loop wave that tagged rows, or
    once after the fused waves if they tagged any), ``"overdeleted"``
    (tombstones finalised), ``"split"`` (suspect cliques split, the program
    rewritten), ``"rederive"`` (the targeted joins done); then the forward
    fixpoint runs and the generator ends.  Exhaust it or roll back; a
    no-effect delta yields nothing."""
    dev = engine.device
    log = engine._log
    engine._ensure_index(state)
    delta = dedup_rows(delta)
    if delta.shape[0] and state.explicit.shape[0]:
        dk = torch.from_numpy(pack(delta)).to(dev)
        delta = delta[log.read(lambda: _keys_in(state.explicit, dk).cpu().numpy())]
    else:
        delta = np.zeros((0, 3), np.int32)
    if delta.shape[0] == 0:
        return

    gone = torch.from_numpy(np.sort(pack(delta))).to(dev)
    explicit_new = state.explicit[~_keys_in(gone, state.explicit)]
    rep_old = state.rep
    rep_host = log.read(lambda: rep_old.cpu().numpy())
    sizes = torch.zeros(state.n_res, dtype=I32, device=dev).index_add_(
        0, rep_old.to(I64), torch.ones_like(rep_old))  # clique sizes

    # -- backward: seed + overdelete waves (epoch-tagged tombstones) ---------
    nf_t, _owner = ops.rewrite_owner(torch.from_numpy(delta).to(dev), rep_old, 1)
    nf = dedup_rows(log.read(lambda: nf_t.cpu().numpy()))
    q, qv = _padded(engine, torch.from_numpy(nf).to(dev))
    state.tomb, n_seed = _seed_tombs(state.sorted_keys, state.sort_perm,
                                     state.epoch, state.marked, state.tomb, q, qv)
    n_od_host = log.read(lambda: int(n_seed))
    yield "seeded"

    suspect = torch.zeros(state.n_res, dtype=torch.bool, device=dev)
    if engine.fuse_rounds:
        suspect, n_waved = yield from _fused_waves(engine, state, sizes, suspect,
                                                   max_rounds)
        n_od_host += n_waved
    else:
        # wave-1 frontier masks come from the seed normal forms
        masks = np.zeros((3, state.n_res), dtype=bool)
        for pos in range(3):
            masks[pos][nf[:, pos]] = True
        w = 0
        while True:
            w += 1
            state.stats.od_waves += 1
            heads, hv = _tomb_heads(engine, state, w, masks)
            state.tomb, suspect, n_new, _ov_route, ov_refl, od_masks = _od_step(
                state.spo, state.epoch, state.marked, state.tomb,
                state.sorted_keys, state.sort_perm, state.rep, sizes, suspect,
                heads, hv, w, refl_cap=engine._active_delta_out,
            )
            n_new, ov_refl = log.read(
                torch.stack([n_new.to(I64), ov_refl.to(I64)]).tolist)
            if ov_refl:
                raise CapacityError(engine._active_delta_kind)
            if n_new == 0:
                break
            n_od_host += n_new
            masks = log.read(od_masks.cpu().numpy)
            yield "wave"

    # the rederive seeds and the restored stream scale with the overdelete
    engine._presize_delta(max(n_od_host, delta.shape[0]))

    # the overdeleted rows for the head-bound joins, before finalize
    od_rows = np.zeros((0, 3), np.int32)
    if n_od_host and engine.rederive_mode == "targeted":
        rows, rv, ov = _extract_tombed(state.spo, state.tomb, _pow2(n_od_host))
        if log.read(lambda: bool(ov)):
            raise RuntimeError(
                "overdelete extraction overflowed its host-counted bound "
                f"({n_od_host} rows): tombstone accounting is inconsistent")
        od_rows = log.read(lambda: rows[rv].cpu().numpy())

    (state.marked, state.tomb, state.sorted_keys, state.sort_perm,
     od_mask, n_od) = _finalize_tombs(state.spo, state.epoch, state.marked,
                                      state.tomb, state.sorted_keys,
                                      state.sort_perm, state.rep)
    n_od = log.read(lambda: int(n_od))
    state.stats.overdeleted += n_od
    yield "overdeleted"

    # -- split: suspect cliques revert to singletons -------------------------
    state.stats.suspects_split += log.read(lambda: int(suspect.sum()))
    ids = torch.arange(state.n_res, dtype=I32, device=dev)
    rep_split = torch.where(suspect[rep_old.to(I64)], ids, rep_old)
    p_split, _ = state.base_program.rewrite(log.read(lambda: rep_split.cpu().numpy()))
    state.rep = rep_split
    state.program = p_split
    yield "split"

    # -- rederive: restore overdeleted facts still derivable from survivors --
    od_mask_h = log.read(lambda: od_mask.cpu().numpy()) if n_od else None
    requeued = []
    seeds: list[np.ndarray] = []
    if n_od:
        for k, rule in enumerate(p_split.rules):
            if not _head_may_rederive(rule, od_mask_h, rep_host):
                continue
            if engine.rederive_mode != "targeted":
                requeued.append(k)
                state.stats.rederive_full_fallback += 1
                continue
            bind = _head_bindings(rule, od_rows, rep_host)
            if bind is None:
                requeued.append(k)
                state.stats.rederive_full_fallback += 1
            elif bind.shape[0]:
                heads = engine._eval_rule_rederive(state, k, rule, bind)
                state.stats.rederive_targeted += 1
                if heads.shape[0]:
                    seeds.append(heads)
    yield "rederive"

    # seeds: the rederived instances, the explicit rows whose post-split
    # normal form went missing, the missing reflexive witnesses of the
    # resources surviving in the store
    if explicit_new.shape[0]:
        rows = _unpack3(explicit_new)
        nf_exp, _ = ops.rewrite_triples(rows, rep_split)
        miss = ~_member_query(engine, state, nf_exp)
        missing = log.read(lambda: rows[miss].cpu().numpy())
        if missing.shape[0]:
            seeds.append(missing)
    occ = _occupancy(state.spo, state.epoch, state.marked, state.rep) if n_od else None
    if n_od and log.read(lambda: bool(occ.any())):
        occ[SAME_AS] = True
        res = torch.nonzero(occ).reshape(-1).to(I32)
        refl = torch.stack([res, torch.full_like(res, SAME_AS), res], dim=1)
        miss_refl = log.read(
            lambda: refl[~_member_query(engine, state, refl)].cpu().numpy())
        if miss_refl.shape[0]:
            seeds.append(miss_refl)
    cands = (dedup_rows(np.concatenate(seeds, axis=0)) if seeds
             else np.zeros((0, 3), np.int32))

    state.explicit = explicit_new
    state.stats.triples_explicit = int(explicit_new.shape[0])
    cj, cv = engine._pad_cands(cands)
    engine._forward(state, cj, cv, requeued, max_rounds)


def _fused_waves(engine, state: EngineState, sizes, suspect, max_rounds: int):
    """The fused overdelete waves (a :class:`~repro_torch.core.fused.WaveGraph`
    replay a wave on the card) into ``state.tomb``; yields ``"wave"`` once
    if they tagged rows and returns ``(suspect, rows tagged)``."""
    from .fused import WaveGraph, forward_plan_signature, fused_delete_waves

    plans = forward_plan_signature(state.program, tombstone=True)
    caps = dict(bind_cap=engine._active_bind,
                plan_out_cap=engine._active_delta_out,
                refl_cap=engine._active_delta_out)
    graph = None
    if engine._use_graphs:
        n_pad = _pow2(state.n_res)
        key = ("wave", plans, engine.capacity, engine._active_bind,
               engine._active_delta_out, n_pad)
        graph = engine._graphs.get(key)
        if graph is None:
            graph = engine._graphs[key] = WaveGraph(key, state, plans, caps, n_pad)
    tomb, suspect, fl = fused_delete_waves(
        state, sizes, suspect, max_rounds, plans=plans, log=engine._log,
        graph=graph, **caps)
    if graph is not None and graph.captured_now:
        engine._count_capture(graph)
    state.stats.od_waves += fl["iters"]
    if fl["ov_route"]:
        raise CapacityError("route")
    if fl["ov_bind"]:
        raise CapacityError(engine._active_bind_kind)
    if fl["ov_refl"] or fl["ov_out"] or fl["ov_squeeze"]:
        raise CapacityError(engine._active_delta_kind)
    if fl["n_new"] > 0:
        raise RuntimeError("did not converge")
    state.tomb = tomb
    if fl["n_od"]:
        yield "wave"
    return suspect, fl["n_od"]


def spmd_delete_facts(engine, state: EngineState, delta, max_rounds: int) -> EngineState:
    """Deletions: tombstone waves, clique split and rederivation on the
    device."""
    for _phase in spmd_delete_phases(engine, state, delta, max_rounds):
        pass
    return state
