"""Materialisation statistics mirroring the paper's Table 2 columns.

The port's copy of ``repro.core.stats.MatStats``: the counters the REW
fixpoint, incremental maintenance (:mod:`repro_torch.core.incremental_spmd`)
and the host AX/REW materialisations (:mod:`repro_torch.core.materialise`)
book, under the same names, so the two packages compare field by field.
"""

from __future__ import annotations

import dataclasses


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
    memory_bytes: int = 0           # host arena bytes (AX / host REW)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
