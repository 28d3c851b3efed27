"""Materialisation statistics mirroring the paper's Table 2 columns.

The base-run subset of ``repro.core.stats.MatStats``: the counters the REW
fixpoint and the host AX/REW materialisations (:mod:`repro_torch.core.materialise`)
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
    find capacities that hold it (the reference books none for base runs).
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
    full_plan_evals: int = 0        # unconstrained full-plan rule evaluations
    delta_mask_fallbacks: int = 0   # delta windows that overflowed to all-True masks
    capacity_retries: int = 0       # capacity-overflow restarts of the run
    triples_total: int = 0          # arena rows used (marked + unmarked)
    triples_unmarked: int = 0
    triples_explicit: int = 0
    wall_seconds: float = 0.0
    memory_bytes: int = 0           # host arena bytes (AX / host REW)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
