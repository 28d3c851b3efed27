"""Quickstart: the paper's running example (§3/§4, Table 1).

Materialises P_ex = {(R), (S), F1..F3} about :Obama / :USPresident /
:USA / :US / :America with explicit owl:sameAs axiomatisation (AX, the
host oracle) and with rewriting (REW, :class:`TorchEngine` on the device),
and prints the numbers the paper quotes: >60 derivations under AX against
single digits of rule derivations under REW, a final store of one
presidentOf fact and its reflexive sameAs facts, and the representative
map.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
from types import SimpleNamespace

from repro_torch.core.engine import TorchEngine
from repro_torch.core.materialise import check_theorem1, expand, materialise
from repro_torch.data.datasets import pex


def name_triples(triples, dic):
    return sorted(
        f"<{dic.lookup(s)}, {dic.lookup(p)}, {dic.lookup(o)}>" for s, p, o in triples
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where REW runs (cuda or cpu)")
    args = ap.parse_args(argv)

    facts, program, dic = pex()
    print("Input facts:")
    for row in name_triples(facts, dic):
        print("  ", row)

    ax = materialise(facts, program, dic.n_resources, mode="AX")
    triples, rep, stats = TorchEngine(dic.n_resources, device=args.device).materialise(
        facts, program)
    rew = SimpleNamespace(triples=lambda: triples, rep=rep, stats=stats)
    check_theorem1(rew, ax)  # Theorem 1 (1)-(3) + expansion == AX

    print("\nAX  (explicit ~=1..~=5 axiomatisation):")
    print(f"   triples: {ax.stats.triples_unmarked}")
    print(f"   derivations: {ax.stats.derivations}   (paper: >60 for sameAs alone)")

    print("\nREW (the paper's rewriting algorithm):")
    print(f"   triples (unmarked): {rew.stats.triples_unmarked}")
    print(f"   derivations: {rew.stats.derivations}   (paper: 6)")
    print(f"   merged resources: {rew.stats.merged_resources}")
    print("   final store:")
    for row in name_triples(rew.triples(), dic):
        print("     ", row)

    print("\nRepresentative map (non-identity):")
    for rid in range(dic.n_resources):
        r = int(rew.rep[rid])
        if r != rid:
            print(f"   rho({dic.lookup(rid)}) = {dic.lookup(r)}")

    exp = expand(rew.triples(), rew.rep)
    ax_set = {tuple(t) for t in ax.triples()}
    print(f"\nTheorem 1(3): |T^rho| = {len(exp)} == |AX| = {len(ax_set)}:",
          exp == ax_set)


if __name__ == "__main__":
    main()
