"""Trace audit: the invariant passes over recorded traces, and the dispatch
auditor.  The port of ``repro.analysis``.

The engine's hot-path guarantees — no arena-length sorts inside the round
units, delta-width scatters, packed keys staying int64, no host reads
inside a unit, a bounded set of dispatch families per maintenance phase —
are checked here:

  * :func:`repro_torch.analysis.passes.record` runs a unit once and records
    what it did (aten ops through a dispatch mode, kernel launches with
    their operand shapes, host reads); the reference walks jaxprs instead;
  * :mod:`repro_torch.analysis.passes` — the reference's four passes
    (``NoArenaSort``, ``NoArenaScatter``, ``DtypeSafety``,
    ``NoHostCallback``) over such traces, each returning :class:`Violation`
    records that name the pass, the unit, the offending op and where it ran;
  * the **inventory** — every family of units registers a trace builder in
    ``repro_torch.core.engine.AUDIT_REGISTRY``
    (:func:`repro_torch.core.engine.register_auditable`); :func:`audit_engine`
    records the whole registry at a *probe geometry* (the arena strictly
    larger than every other buffer, so "arena-length" is unambiguous) and
    runs every applicable pass;
  * the **dispatch auditor** — :func:`static_dispatch_profile` (in
    :mod:`repro_torch.core.incremental_spmd`) states which families each
    maintenance phase may dispatch; the runtime side is
    :class:`repro_torch.core.stats.DispatchCounter` on
    ``TorchEngine.dispatches``; :func:`dispatch_crosscheck` reconciles the
    two.

``python -m repro_torch.analysis --check --device cpu`` audits the
registered inventory and exits non-zero on a violation or a dispatch
problem; without ``--device`` it runs on the card.
"""

from __future__ import annotations

from .passes import (
    ALL_PASSES,
    AnalysisPass,
    DtypeSafety,
    Event,
    NoArenaScatter,
    NoArenaSort,
    NoHostCallback,
    TensorMeta,
    Violation,
    count_sorts_at_least,
    record,
)

__all__ = [
    "ALL_PASSES",
    "AnalysisPass",
    "DtypeSafety",
    "Event",
    "NoArenaScatter",
    "NoArenaSort",
    "NoHostCallback",
    "TensorMeta",
    "Violation",
    "audit_engine",
    "audited_fn_labels",
    "build_probe",
    "count_sorts_at_least",
    "dispatch_crosscheck",
    "record",
    "record_inventory",
    "run_report",
]


# ---------------------------------------------------------------------------
# inventory audit
# ---------------------------------------------------------------------------

def build_probe(dataset: str = "pex", capacity: int = 4096, cap: int = 256,
                device: str = "cuda"):
    """A representative engine and materialised state for recording the
    registry, on ``device``.

    The arena is strictly larger than every other buffer (checked), so an
    arena-length operand is unambiguous in the traces: the reference's
    probe geometry and datasets.  Returns ``(engine, state, program)``.
    """
    from repro_torch.core.engine import TorchEngine
    from repro_torch.data.datasets import clique_with_spokes, pex, single_clique

    if dataset == "pex":
        facts, prog, dic = pex()
    elif dataset == "chain":
        facts, prog, dic = single_clique(8)
    elif dataset == "clique":
        facts, prog, dic = clique_with_spokes(6, 4)
    elif dataset == "dbpedia_like":
        from repro_torch.data.generator import generate

        facts, prog, dic = generate(
            n_groups=2, group_size=3, n_spokes_per=2, n_plain=40,
            hierarchy_depth=2, chain_rules=True, seed=5,
        )
    else:
        raise ValueError(f"unknown probe dataset {dataset!r}")
    eng = TorchEngine(
        dic.n_resources, capacity=capacity, bind_cap=cap, out_cap=cap,
        rewrite_cap=cap, device=device,
    )
    state = eng.materialise_state(facts, prog)
    arena_rows = int(state.spo.shape[0])
    if arena_rows <= 4 * max(eng.bind_cap, eng.out_cap, eng.rewrite_cap):
        raise RuntimeError(
            "probe geometry degenerated: arena must dominate every buffer "
            f"(arena {arena_rows}, caps {eng.bind_cap}/{eng.out_cap}/"
            f"{eng.rewrite_cap}) — capacity growth during materialisation?"
        )
    return eng, state, prog


def _registry():
    from repro_torch.core import incremental_spmd  # noqa: F401  (registers units)
    from repro_torch.core.engine import AUDIT_REGISTRY
    from repro_torch.sparql import batched  # noqa: F401  (registers "bgp")

    return AUDIT_REGISTRY


def record_inventory(engine, state) -> list:
    """Run every registered unit once under the recorder:
    ``[(spec, label, trace)]``."""
    out = []
    for spec in _registry().values():
        for label, run in spec.builder(engine, state):
            out.append((spec, label, record(run)))
    return out


def _violations(recorded, arena_rows: int, passes=None) -> list[Violation]:
    passes = list(ALL_PASSES) if passes is None else list(passes)
    violations: list[Violation] = []
    for spec, label, trace in recorded:
        for p in passes:
            if p.name not in spec.skip_passes:
                violations += p.run(label, trace, arena_rows)
    return violations


def audit_engine(engine, state, passes=None) -> list[Violation]:
    """Record every registered unit and run the applicable passes.

    Each registry entry may exempt itself from specific passes (the index
    rebuild is the one allowed arena sort).  ``arena_rows`` for the length
    thresholds is the state's arena length.
    """
    return _violations(record_inventory(engine, state),
                       int(state.spo.shape[0]), passes)


def audited_fn_labels(engine, state) -> list[str]:
    """The labels of every unit in the registered inventory."""
    return [label for spec in _registry().values()
            for label, _ in spec.builder(engine, state)]


# ---------------------------------------------------------------------------
# dispatch auditor (static profile x runtime counter cross-check)
# ---------------------------------------------------------------------------

def dispatch_crosscheck(counter, program=None) -> list[str]:
    """Verify runtime dispatches against the static per-phase profile.

    ``counter`` is a :class:`repro_torch.core.stats.DispatchCounter`
    populated by running maintenance through the engine; every (phase,
    family) pair it observed must be admitted by
    :func:`repro_torch.core.incremental_spmd.static_dispatch_profile` — a
    family dispatching inside a tagged phase that does not list it joined a
    hot path without declaring itself.  Dispatches outside any phase
    (``phase=None``: the base fixpoint, direct engine use) are not
    checked.  Returns problem strings (empty == consistent).
    """
    from repro_torch.core.incremental_spmd import static_dispatch_profile

    profile = static_dispatch_profile(program)
    problems: list[str] = []
    for (phase, family), n in sorted(
        counter.by_phase.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])
    ):
        if phase is None:
            continue
        allowed = profile.get(phase)
        if allowed is None:
            problems.append(
                f"dispatches under unknown phase {phase!r} (family {family} x{n})"
            )
        elif family not in allowed:
            problems.append(
                f"{phase}: dispatched unregistered fn family {family!r} x{n} "
                f"(static profile allows {sorted(allowed)})"
            )
    return problems


def run_report(dataset: str = "pex", events: int = 2, device: str = "cuda") -> dict:
    """The full audit as a JSON-able report dict (the CLI's).

    Records the registered inventory at the probe geometry on ``device``
    and runs every pass; then drives ``events`` small maintenance
    operations (a delete, then an add, alternating) through the engine so
    the runtime dispatch counter is populated, and cross-checks it against
    the static phase profile.  ``launches`` lists the kernel entry points
    each family's units launched (none on the CPU).
    """
    import numpy as np

    from repro_torch.core.engine import TorchEngine
    from repro_torch.core.incremental_spmd import static_dispatch_profile

    engine, state, program = build_probe(dataset, device=device)
    recorded = record_inventory(engine, state)
    arena_rows = int(state.spo.shape[0])
    violations = _violations(recorded, arena_rows)
    launches: dict[str, set] = {}
    for spec, _label, trace in recorded:
        launches.setdefault(spec.name, set()).update(
            ev.op for ev in trace if ev.kind == "launch")

    # drive a tiny update stream so every maintenance phase dispatches
    explicit = TorchEngine.explicit_rows(state)
    for i in range(events):
        k = min(2, explicit.shape[0])
        rows = explicit[:k] if k else np.zeros((0, 3), np.int32)
        if i % 2 == 0 and rows.shape[0]:
            engine.delete_facts(state, rows)
        elif rows.shape[0]:
            engine.add_facts(state, rows)
        explicit = TorchEngine.explicit_rows(state)
    dispatch_problems = dispatch_crosscheck(engine.dispatches, program)

    return {
        "dataset": dataset,
        "device": str(engine.device),
        "arena_rows": arena_rows,
        "passes": [p.name for p in ALL_PASSES],
        "fns": sorted(label for _, label, _ in recorded),
        "violations": [v.as_dict() for v in violations],
        "launches": {fam: sorted(ops) for fam, ops in sorted(launches.items())},
        "dispatch": {
            "static_profile": {
                ph: dict(sorted(fams.items()))
                for ph, fams in static_dispatch_profile(program).items()
            },
            "runtime_by_family": dict(sorted(engine.dispatches.by_family.items())),
            "runtime_by_phase": {
                f"{ph}/{fam}": n
                for (ph, fam), n in sorted(
                    engine.dispatches.by_phase.items(),
                    key=lambda kv: (str(kv[0][0]), kv[0][1]),
                )
                if ph is not None
            },
            "compiles_by_family": dict(sorted(engine.dispatches.compiles.items())),
            "total": engine.dispatches.total,
            "problems": dispatch_problems,
        },
    }
