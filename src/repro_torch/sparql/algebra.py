"""Minimal SPARQL algebra over rewritten triples (paper §5).

A query is a basic graph pattern plus an ordered list of post-steps
(FILTER / BIND) and a final projection.  Enough expressiveness to exercise
the paper's two correctness hazards:

  * bag semantics — projected-out variables must contribute clique-size
    multiplicities,
  * builtins — arguments must be expanded *before* the builtin runs, and
    expanded variables must not be multiplied again at projection.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.rules import _ATOM_RE, parse_term
from repro_torch.core.terms import Dictionary

Atom = tuple[int, int, int]


@dataclass(frozen=True)
class Bind:
    """BIND(fn(?src) AS ?dst); fn is a builtin over the *resource name*."""

    fn: str  # 'STR' | 'UCASE'
    src: int
    dst: int


@dataclass(frozen=True)
class FilterEq:
    """FILTER(?var = <resource>) — resource-level equality (pre-expansion it
    must be evaluated on expanded bindings, like a builtin)."""

    var: int
    value: int


@dataclass
class Query:
    patterns: list[Atom]
    steps: list = field(default_factory=list)
    select: list[int] = field(default_factory=list)
    distinct: bool = False

    @staticmethod
    def parse(text: str, dic: Dictionary) -> "Query":
        """Parse ``SELECT ?x ?y WHERE { (s,p,o) . (s,p,o) }`` mini-syntax."""
        head, _, body = text.partition("WHERE")
        varmap: dict[str, int] = {}
        patterns = [
            tuple(parse_term(t, dic, varmap) for t in m)
            for m in _ATOM_RE.findall(body)
        ]
        select = [parse_term(tok, dic, varmap) for tok in head.split() if tok.startswith("?")]
        distinct = "DISTINCT" in head
        return Query(patterns, [], select, distinct)

    def bind(self, fn: str, src: int, dst: int) -> "Query":
        self.steps.append(Bind(fn, src, dst))
        return self

    def filter_eq(self, var: int, value: int) -> "Query":
        self.steps.append(FilterEq(var, value))
        return self
