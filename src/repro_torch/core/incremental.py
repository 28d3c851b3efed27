"""Incremental maintenance on the host: the numpy oracle and yardstick.

A numpy copy of ``repro.core.incremental``, the bulk-synchronous
adaptation of Motik et al.'s rewriting-aware incremental maintenance
(arXiv:1505.00212) over :func:`repro_torch.core.materialise.rew_rounds`:

``add_facts``
    Seeds the shared round loop with the fresh explicit triples: the
    semi-naive delta discipline considers exactly the substitutions that
    involve at least one new fact.

``delete_facts``
    A rewriting-aware Backward/Forward pass: overdelete (the DRed backward
    closure against the pre-deletion store, plus the reflexivity children
    of every overdeleted fact), split every sameAs clique whose reflexive
    witness was overdeleted (and overdelete every fact touching it), then
    rederive: the explicit triples whose normal form went missing, the heads
    derivable in one step from the surviving store and the reflexive
    witnesses of surviving resources seed :func:`rew_rounds` again.

After any update the state equals the from-scratch REW materialisation of
the updated explicit set: the same rho and the same normal-form store.
:class:`repro_torch.core.engine.TorchEngine` maintains its state on the
device (:mod:`repro_torch.core.incremental_spmd`); this module is the host
path its ``materialise_incremental(on_device=False)`` replays.

``normal_forms(use_kernel=True)`` runs the rewrite through the port's
``rewrite_triples`` (the kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .materialise import MatResult, rew_rounds
from .rules import Program, Rule
from .seminaive import _const_filter, eval_rule_delta, eval_rule_full
from .stats import MatStats
from .terms import SAME_AS, is_var
from .triples import TripleArena, dedup_rows, pack, setdiff_rows
from .uf import clique_sizes, split_cliques

__all__ = [
    "IncrementalState",
    "materialise_incremental",
    "add_facts",
    "delete_facts",
    "normal_forms",
]


def normal_forms(spo: np.ndarray, rep: np.ndarray, use_kernel: bool = False,
                 device: str = "cuda") -> np.ndarray:
    """``rho[spo]`` for an (n, 3) batch; with ``use_kernel`` through
    :func:`repro_torch.kernels.ops.rewrite_triples` on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
    if spo.shape[0] == 0:
        return spo
    if use_kernel:
        import torch

        from repro_torch.device import resolve
        from repro_torch.kernels import ops

        dev = resolve(device, "normal_forms")
        out, _changed = ops.rewrite_triples(
            torch.from_numpy(spo).to(dev),
            torch.from_numpy(np.asarray(rep, np.int32)).to(dev),
        )
        return out.cpu().numpy()
    return rep[spo].astype(np.int32)


@dataclass
class IncrementalState:
    """A materialised store that supports add/delete maintenance.

    ``rep`` is always fully compressed; ``program`` is the current rewritten
    program rho(``base_program``); ``explicit`` is the current explicit fact
    set in original resource IDs (the set a from-scratch run would start
    from); ``stats`` accumulates across the base run and every update.
    """

    arena: TripleArena
    rep: np.ndarray
    program: Program
    base_program: Program
    explicit: np.ndarray
    n_resources: int
    stats: MatStats = field(default_factory=lambda: MatStats(mode="REW-inc"))
    use_kernel: bool = False
    device: str = "cuda"

    def result(self) -> MatResult:
        self.stats.triples_total = self.arena.total
        self.stats.triples_unmarked = self.arena.unmarked
        self.stats.memory_bytes = self.arena.nbytes
        return MatResult(self.arena, self.rep, self.program, self.stats)

    def triples(self) -> np.ndarray:
        return self.arena.valid_triples()

    def normal_forms(self, spo: np.ndarray, rep: np.ndarray) -> np.ndarray:
        return normal_forms(spo, rep, self.use_kernel, self.device)

    def _grow_rep(self, facts: np.ndarray) -> None:
        """Extend rho with identity entries for unseen resource IDs."""
        if facts.shape[0] == 0:
            return
        hi = int(facts.max()) + 1
        if hi > self.rep.shape[0]:
            ext = np.arange(self.rep.shape[0], hi, dtype=self.rep.dtype)
            self.rep = np.concatenate([self.rep, ext])
            self.n_resources = hi


def materialise_incremental(
    facts: np.ndarray,
    program: Program,
    n_resources: int,
    max_rounds: int = 10_000,
    use_kernel: bool = False,
    device: str = "cuda",
) -> IncrementalState:
    """From-scratch REW materialisation that returns a maintainable state."""
    t0 = time.perf_counter()
    stats = MatStats(mode="REW-inc")
    arena = TripleArena()
    rep = np.arange(n_resources, dtype=np.int32)
    facts = dedup_rows(facts)
    stats.triples_explicit = facts.shape[0]
    rep, p_cur = rew_rounds(arena, rep, program, facts, stats, max_rounds)
    stats.wall_seconds += time.perf_counter() - t0
    return IncrementalState(
        arena=arena, rep=rep, program=p_cur, base_program=program,
        explicit=facts, n_resources=n_resources, stats=stats,
        use_kernel=use_kernel, device=device,
    )


def add_facts(state: IncrementalState, delta: np.ndarray,
              max_rounds: int = 10_000) -> IncrementalState:
    """Add explicit triples and maintain the materialisation in place.

    May raise :class:`repro_torch.core.materialise.Contradiction`; the
    state is then partially updated and should be discarded, like a failed
    from-scratch run.
    """
    t0 = time.perf_counter()
    delta = dedup_rows(delta)
    delta = setdiff_rows(delta, state.explicit)
    if delta.shape[0] == 0:
        state.stats.wall_seconds += time.perf_counter() - t0
        return state
    state._grow_rep(delta)
    state.explicit = np.concatenate([state.explicit, delta], axis=0)
    state.stats.triples_explicit = state.explicit.shape[0]
    state.rep, state.program = rew_rounds(
        state.arena, state.rep, state.program, delta, state.stats, max_rounds
    )
    state.stats.wall_seconds += time.perf_counter() - t0
    return state


def _rule_touches(rule: Rule, f_spo: np.ndarray) -> bool:
    """True iff some frontier fact matches some body atom's constant
    pattern (else the rule's delta plans cannot join the wave)."""
    for atom in rule.body:
        if _const_filter(atom, f_spo).any():
            return True
    return False


def _rule_may_rederive(rule: Rule, o_spo: np.ndarray, rep_old: np.ndarray) -> bool:
    """False iff no overdeleted fact can match the rule's head pattern
    (head constants collapsed through the pre-deletion rho, under which the
    overdeleted rows are normal)."""
    if o_spo.shape[0] == 0:
        return False
    mask = np.ones(o_spo.shape[0], dtype=bool)
    for pos, t in enumerate(rule.head):
        if not is_var(t):
            mask &= o_spo[:, pos] == rep_old[t]
    return bool(mask.any())


def _overdelete(state: IncrementalState,
                deleted: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The backward half of the B/F pass: ``(overdel_rows, suspect_reps)``,
    the arena rows to retract and the representatives of the cliques to
    split.  The arena is not modified here."""
    arena, rep = state.arena, state.rep
    n = arena.n
    valid = arena.valid[:n]
    spo_all = arena.spo[:n]
    t_snapshot = spo_all[valid]  # the pre-deletion store (DRed's T)

    overdel = np.zeros(n, dtype=bool)
    suspect = np.zeros(rep.shape[0], dtype=bool)
    sizes = clique_sizes(rep)

    # seed: normal forms of the deleted explicit triples
    frontier = arena.rows_of(state.normal_forms(deleted, rep))
    overdel[frontier] = True

    while frontier.shape[0]:
        # 1) backward rule closure: >= 1 body atom in the frontier, the
        # rest anywhere in the pre-deletion store
        f_spo = spo_all[frontier]
        outs = []
        for rule in state.program:
            if not _rule_touches(rule, f_spo):
                continue
            h, _nd, _na = eval_rule_delta(rule, t_snapshot, t_snapshot, f_spo)
            if h.shape[0]:
                outs.append(h)
        heads = (np.concatenate(outs, axis=0) if outs
                 else np.zeros((0, 3), np.int32))
        heads = state.normal_forms(heads, rep)

        new_rows = arena.rows_of(heads)
        new_rows = new_rows[~overdel[new_rows]]

        # 2) reflexivity children of every resource of this wave
        res = np.unique(np.append(np.unique(f_spo), SAME_AS))
        refl = np.stack([res, np.full_like(res, SAME_AS), res], axis=1).astype(np.int32)
        refl_rows = arena.rows_of(refl)
        refl_rows = refl_rows[~overdel[refl_rows]]
        new_rows = np.concatenate([new_rows, refl_rows])

        # 3) suspect cliques: an overdeleted reflexive witness of a
        # multi-member clique; every fact touching it is grabbed
        wit = np.concatenate([frontier, new_rows])
        wit_spo = spo_all[wit]
        is_wit = ((wit_spo[:, 1] == SAME_AS) & (wit_spo[:, 0] == wit_spo[:, 2])
                  & (sizes[wit_spo[:, 0]] > 1))
        fresh_sus = np.unique(wit_spo[is_wit][:, 0])
        fresh_sus = fresh_sus[~suspect[fresh_sus]]
        if fresh_sus.shape[0]:
            suspect[fresh_sus] = True
            touch = valid & ~overdel & np.isin(spo_all, fresh_sus).any(axis=1)
            touch[wit] = False  # already in this wave
            new_rows = np.concatenate([new_rows, np.flatnonzero(touch)])

        overdel[new_rows] = True
        frontier = np.unique(new_rows)

    return np.flatnonzero(overdel), np.flatnonzero(suspect)


def delete_facts(state: IncrementalState, delta: np.ndarray,
                 max_rounds: int = 10_000) -> IncrementalState:
    """Retract explicit triples and maintain the materialisation in place;
    rows of ``delta`` that are not explicit are ignored."""
    t0 = time.perf_counter()
    delta = dedup_rows(delta)
    if delta.shape[0] and state.explicit.shape[0]:
        delta = delta[np.isin(pack(delta), pack(state.explicit))]
    else:
        delta = np.zeros((0, 3), np.int32)
    if delta.shape[0] == 0:
        state.stats.wall_seconds += time.perf_counter() - t0
        return state

    explicit_new = setdiff_rows(state.explicit, delta)

    # backward: overdelete and find the suspect cliques
    overdel_rows, suspect_reps = _overdelete(state, delta)
    state.arena.mark_rows(overdel_rows)

    # split: suspect cliques revert to singletons; rules re-rewritten
    rep_split = split_cliques(state.rep, suspect_reps)
    p_split, _changed = state.base_program.rewrite(rep_split)

    # forward: rederive and run the shared round loop
    seeds = []
    if explicit_new.shape[0]:
        # seed 1: explicit facts whose normal form went missing
        nf = state.normal_forms(explicit_new, rep_split)
        miss = ~state.arena.contains(nf)
        if miss.any():
            seeds.append(explicit_new[miss])
    t_surv = state.arena.valid_triples()
    if t_surv.shape[0] and overdel_rows.shape[0]:
        # seed 2: heads derivable in one step from the surviving store
        o_spo = state.arena.spo[overdel_rows]
        for rule in p_split:
            if not _rule_may_rederive(rule, o_spo, state.rep):
                continue
            h, _nd, _na = eval_rule_full(rule, t_surv)
            if h.shape[0]:
                seeds.append(h)
        # seed 3: reflexive witnesses of resources that survive
        res = np.unique(np.append(np.unique(t_surv), SAME_AS))
        refl = np.stack([res, np.full_like(res, SAME_AS), res], axis=1).astype(np.int32)
        miss_refl = refl[~state.arena.contains(refl)]
        if miss_refl.shape[0]:
            seeds.append(miss_refl)
    cands = (dedup_rows(np.concatenate(seeds, axis=0)) if seeds
             else np.zeros((0, 3), np.int32))
    if cands.shape[0]:
        cands = cands[~state.arena.contains(state.normal_forms(cands, rep_split))]

    rep_new, p_new = rew_rounds(state.arena, rep_split, p_split, cands,
                                state.stats, max_rounds)
    state.rep = rep_new
    state.program = p_new
    state.explicit = explicit_new
    state.stats.triples_explicit = explicit_new.shape[0]
    state.stats.wall_seconds += time.perf_counter() - t0
    return state
