"""Materialisation statistics mirroring the paper's Table 2 columns.

The port's copy of ``repro.core.stats``: the counters the REW fixpoint,
incremental maintenance (:mod:`repro_torch.core.incremental_spmd`) and the
host AX/REW materialisations (:mod:`repro_torch.core.materialise`) book,
under the same names, so the two packages compare field by field; and the
runtime half of the dispatch auditor, :class:`DispatchCounter`.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter

from . import spans


class DispatchCounter:
    """Runtime side of the dispatch auditor (``TorchEngine.dispatches``).

    Every unit of work the reference dispatches as one compiled call records
    one dispatch here under its *family* ("plan", "process", "fforward",
    "seed_tombs", ...): on the card a fused round or wave is one CUDA graph
    replay, on the CPU the same body run eagerly.  When a maintenance
    generator has tagged the current phase via the ``phase`` attribute, the
    dispatch also counts under that ``(phase, family)`` pair.  Graph
    captures are tallied in ``compiles``, so steady-state dispatch rates
    read net of them.  The static half is
    :func:`repro_torch.core.incremental_spmd.static_dispatch_profile`;
    :func:`repro_torch.analysis.dispatch_crosscheck` reconciles the two.

    ``phase`` is thread-local (the serving tier's maintenance worker tags
    its phases while reader threads dispatch their ``"query"`` work), and
    the increments take a lock, so totals stay exact across threads.  With
    the spans on (:mod:`repro_torch.core.spans`), setting it also closes the
    previous phase's range on this thread and opens the new one's.
    """

    def __init__(self) -> None:
        self.by_family: Counter = Counter()
        self.by_phase: Counter = Counter()   # keyed (phase, family)
        self.compiles: Counter = Counter()   # graph captures
        self._phase = threading.local()      # set by the phase generators
        self._lock = threading.Lock()

    @property
    def phase(self) -> str | None:
        return getattr(self._phase, "value", None)

    @phase.setter
    def phase(self, value: str | None) -> None:
        self._phase.value = value
        if spans.enabled():
            spans.phase(value)

    @property
    def total(self) -> int:
        return sum(self.by_family.values())

    def record(self, family: str) -> None:
        with self._lock:
            self.by_family[family] += 1
            self.by_phase[(self.phase, family)] += 1

    def record_compile(self, family: str) -> None:
        with self._lock:
            self.compiles[family] += 1

    def snapshot(self) -> dict:
        """Immutable totals for delta-ing around a timed region."""
        return {
            "by_family": dict(self.by_family),
            "total": self.total,
        }

    def reset(self) -> None:
        self.by_family.clear()
        self.by_phase.clear()
        self.compiles.clear()


@dataclasses.dataclass
class MatStats:
    """Counters collected during materialisation.

    ``derivations`` counts (rule, substitution) pairs that produce a head fact
    (duplicates included) — the paper's 'Derivations' column.
    ``rule_applications`` counts (rule, body-position, delta-fact) partial
    instantiations attempted — the paper's 'Rule appl.' column.
    ``triples_total`` / ``triples_unmarked`` mirror 'Triples after (total /
    unmarked)'.  ``capacity_retries`` counts the restarts a base run took to
    find capacities that hold it (the reference books none for base runs)
    and, as the reference's does, each rollback of an update.
    """

    mode: str = "REW"
    derivations: int = 0
    rule_applications: int = 0
    merged_resources: int = 0
    sameas_pairs: int = 0
    reflexive_added: int = 0
    rounds: int = 0
    rule_rewrites: int = 0          # how many times P' := rho(P) changed P'
    rules_requeued: int = 0         # rules placed on the R queue analogue
    od_waves: int = 0               # overdelete waves (incremental deletes)
    index_rebuilds: int = 0         # full argsorts of the arena index (<=1/epoch)
    overdeleted: int = 0            # rows tombstoned across deletes
    suspects_split: int = 0         # sameAs cliques split + re-merged
    rederive_targeted: int = 0      # delete-side rules evaluated head-bound
    rederive_full_fallback: int = 0 # delete-side whole-rule requeues (const heads)
    rederive_seed_rows: int = 0     # overdeleted head instances joined backward
    rederive_join_width: int = 0    # widest padded rederive seed table
    full_plan_evals: int = 0        # unconstrained full-plan rule evaluations
    remerge_targeted: int = 0       # forward-side rules evaluated merge-anchored
    remerge_full_fallback: int = 0  # forward-side whole-rule requeues (ground atoms)
    delta_mask_fallbacks: int = 0   # delta windows that overflowed to all-True masks
    capacity_retries: int = 0       # capacity-overflow restarts (base run and updates)
    wide_growth_restarts: int = 0   # update retries that grew a wide (base-run) cap
    triples_total: int = 0          # arena rows used (marked + unmarked)
    triples_unmarked: int = 0
    triples_explicit: int = 0
    wall_seconds: float = 0.0
    contradiction: bool = False
    memory_bytes: int = 0           # host arena bytes (AX / host REW)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def factor_over(self, other: "MatStats") -> dict:
        """Ratios AX/REW as in the paper's 'factor' rows."""

        def ratio(a, b):
            return float(a) / float(b) if b else float("inf")

        return {
            "triples": ratio(other.triples_unmarked, self.triples_unmarked),
            "rule_applications": ratio(other.rule_applications, self.rule_applications),
            "derivations": ratio(other.derivations, self.derivations),
            "time": ratio(other.wall_seconds, self.wall_seconds),
        }
