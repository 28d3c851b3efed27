"""Test datasets: the paper's running example P_ex and clique-generators.

The paper evaluates on Claros / DBpedia / OpenCyc / UniProt / UOBM.  Those
dumps are not available offline, so :mod:`repro_torch.data.generator` synthesises
knowledge graphs with the *characteristics* the paper identifies as driving
the AX/REW gap: the number and size of sameAs cliques, the density of triples
over clique members, and (for the UOBM effect) a symmetric+transitive
property that produces equality-free duplicate derivations.

A copy of ``repro.data.datasets``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.rules import Program, parse_facts, parse_program
from repro_torch.core.terms import Dictionary


def pex() -> tuple[np.ndarray, Program, Dictionary]:
    """P_ex from paper §3: rules (R), (S) and facts (F1)-(F3)."""
    dic = Dictionary()
    program = parse_program(
        [
            "(?x, owl:sameAs, :USA) <- (:Obama, :presidentOf, ?x)",
            "(?x, owl:sameAs, :Obama) <- (?x, :presidentOf, :USA)",
        ],
        dic,
    )
    facts = parse_facts(
        [
            "(:USPresident, :presidentOf, :US)",
            "(:Obama, :presidentOf, :America)",
            "(:Obama, :presidentOf, :US)",
        ],
        dic,
    )
    return facts, program, dic


def pex_rule_rewrite() -> tuple[np.ndarray, Program, Dictionary]:
    """P_ex variant where the representative is NOT the rule constant.

    Facts are interned first so ``:US`` gets a smaller ID than ``:USA``;
    min-ID hooking then makes ``:US`` the representative, and rule (S)
    ``(?x, sameAs, :Obama) <- (?x, :presidentOf, :USA)`` can only fire after
    being rewritten to use ``:US`` — the paper's §3 failure case for systems
    that rewrite facts but not rules ("if we choose :US as the representative
    ... rule (S) will not be applicable").
    """
    dic = Dictionary()
    facts = parse_facts(
        [
            "(:USPresident, :presidentOf, :US)",
            "(:Obama, :presidentOf, :America)",
            "(:Obama, :presidentOf, :US)",
        ],
        dic,
    )
    program = parse_program(
        [
            "(?x, owl:sameAs, :USA) <- (:Obama, :presidentOf, ?x)",
            "(?x, owl:sameAs, :Obama) <- (?x, :presidentOf, :USA)",
        ],
        dic,
    )
    return facts, program, dic


def single_clique(n: int) -> tuple[np.ndarray, Program, Dictionary]:
    """n resources a_1..a_n chained by explicit sameAs facts (one clique).

    Used to validate the paper's §3 closed forms for the AX blowup.
    """
    dic = Dictionary()
    ids = dic.intern_many([f":a{i}" for i in range(n)])
    rows = [(ids[i], dic.intern("owl:sameAs"), ids[i + 1]) for i in range(n - 1)]
    return np.asarray(rows, dtype=np.int32), Program([]), dic


def clique_with_spokes(
    n_clique: int, n_spokes: int
) -> tuple[np.ndarray, Program, Dictionary]:
    """A clique of size n plus triples pointing at one clique member.

    Validates the <s,p,o> copy-expansion claim: each spoke triple must expand
    to n copies, each derived (n + 1 + 1) times under AX.
    """
    dic = Dictionary()
    ids = dic.intern_many([f":c{i}" for i in range(n_clique)])
    sa = dic.intern("owl:sameAs")
    p = dic.intern(":spoke")
    rows = [(ids[i], sa, ids[i + 1]) for i in range(n_clique - 1)]
    for j in range(n_spokes):
        s = dic.intern(f":s{j}")
        rows.append((s, p, ids[0]))
    return np.asarray(rows, dtype=np.int32), Program([]), dic
