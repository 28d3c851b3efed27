"""The owl:sameAs axiomatisation P~= (paper §3, rules ~=1 .. ~=5).

AX mode materialises ``[P u P~=]^inf(E)`` by adding these rules to the user
program.  ~=5 (owl:differentFrom contradiction) is enforced as a check rather
than a rule with a ``false`` head.

A copy of ``repro.core.axiom``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from .rules import Program, Rule
from .terms import DIFFERENT_FROM, SAME_AS, var

X1, X2, X3, X1P, X2P, X3P = (var(i) for i in range(1, 7))


def sameas_axiomatisation() -> Program:
    """Rules ~=1 (three instances) and ~=2..~=4.

    ~=1_i:  <x_i, sameAs, x_i> <- <x1, x2, x3>
    ~=2..4: replacement in subject / predicate / object position.
    """
    rules = [
        # ~=1, one per position
        Rule((X1, SAME_AS, X1), ((X1, X2, X3),)),
        Rule((X2, SAME_AS, X2), ((X1, X2, X3),)),
        Rule((X3, SAME_AS, X3), ((X1, X2, X3),)),
        # ~=2: subject replacement
        Rule((X1P, X2, X3), ((X1, X2, X3), (X1, SAME_AS, X1P))),
        # ~=3: predicate replacement
        Rule((X1, X2P, X3), ((X1, X2, X3), (X2, SAME_AS, X2P))),
        # ~=4: object replacement
        Rule((X1, X2, X3P), ((X1, X2, X3), (X3, SAME_AS, X3P))),
    ]
    return Program(rules)


def with_axiomatisation(program: Program) -> Program:
    return Program(list(program.rules) + list(sameas_axiomatisation().rules))


def is_contradiction(s: int, p: int, o: int) -> bool:
    """Rule ~=5: false <- <x, owl:differentFrom, x>."""
    return p == DIFFERENT_FROM and s == o
