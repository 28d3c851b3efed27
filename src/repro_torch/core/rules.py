"""Datalog rule IR and parsing.

A rule is ``head <- body`` where the head is one atom and the body a
conjunction of atoms; an atom is an int32 triple where positive entries are
resource IDs and negative entries are variables (see :mod:`repro_torch.core.terms`).
Rules correspond to SWRL / DL-style OWL 2 RL rules (paper §2).

The paper's key correctness point is that rules must be rewritten alongside
facts: ``rho(rule)`` replaces every *constant* with its representative
(variables are untouched).  ``Program.rewrite`` returns the rewritten program
plus the set of rules that actually changed (the paper's queue ``R``).

A copy of ``repro.core.rules``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .terms import Dictionary, is_var

Atom = tuple[int, int, int]


@dataclass(frozen=True)
class Rule:
    head: Atom
    body: tuple[Atom, ...]

    def __post_init__(self) -> None:
        body_vars = {t for atom in self.body for t in atom if is_var(t)}
        head_vars = {t for t in self.head if is_var(t)}
        if not head_vars <= body_vars:
            raise ValueError(f"unsafe rule: head vars {head_vars - body_vars} not in body")

    @property
    def variables(self) -> tuple[int, ...]:
        seen: list[int] = []
        for atom in self.body:
            for t in atom:
                if is_var(t) and t not in seen:
                    seen.append(t)
        return tuple(seen)

    def constants(self) -> set[int]:
        out = set()
        for atom in (self.head, *self.body):
            for t in atom:
                if not is_var(t):
                    out.add(t)
        return out

    def rewrite(self, rep: np.ndarray) -> "Rule":
        """rho(rule): map every constant through the representative array."""

        def rw(atom: Atom) -> Atom:
            return tuple(int(rep[t]) if t >= 0 else t for t in atom)  # type: ignore[return-value]

        return Rule(rw(self.head), tuple(rw(a) for a in self.body))


class Program:
    """An ordered set of rules with identity-preserving rewriting."""

    def __init__(self, rules: list[Rule]) -> None:
        self.rules = list(rules)

    def __len__(self) -> int:
        return len(self.rules)

    def __iter__(self):
        return iter(self.rules)

    def constants(self) -> set[int]:
        out: set[int] = set()
        for r in self.rules:
            out |= r.constants()
        return out

    def rewrite(self, rep: np.ndarray) -> tuple["Program", list[int]]:
        """Return (rho(P), indices of rules that changed).

        Mirrors Algorithm 1 lines 6-9: the changed rules are the ones queued
        for re-evaluation against the full store.
        """
        new_rules: list[Rule] = []
        changed: list[int] = []
        for i, r in enumerate(self.rules):
            rr = r.rewrite(rep)
            new_rules.append(rr)
            if rr != r:
                changed.append(i)
        return Program(new_rules), changed


_ATOM_RE = re.compile(r"\(\s*([^,()\s]+)\s*,\s*([^,()\s]+)\s*,\s*([^,()\s]+)\s*\)")


def parse_term(tok: str, dic: Dictionary, varmap: dict[str, int]) -> int:
    if tok.startswith("?"):
        if tok not in varmap:
            varmap[tok] = -(len(varmap) + 1)
        return varmap[tok]
    return dic.intern(tok)


def parse_rule(text: str, dic: Dictionary) -> Rule:
    """Parse ``(h) <- (b1) & (b2) ...`` with ``?x`` variables.

    Example: ``(?x, owl:sameAs, :USA) <- (:Obama, :presidentOf, ?x)``
    """
    head_txt, _, body_txt = text.partition("<-")
    varmap: dict[str, int] = {}
    heads = _ATOM_RE.findall(head_txt)
    if len(heads) != 1:
        raise ValueError(f"expected exactly one head atom in {text!r}")
    head = tuple(parse_term(t, dic, varmap) for t in heads[0])
    body = tuple(
        tuple(parse_term(t, dic, varmap) for t in m) for m in _ATOM_RE.findall(body_txt)
    )
    if not body:
        raise ValueError(f"rule with empty body: {text!r}")
    return Rule(head, body)  # type: ignore[arg-type]


def parse_program(lines: list[str] | str, dic: Dictionary) -> Program:
    if isinstance(lines, str):
        lines = [ln for ln in lines.splitlines()]
    rules = []
    for ln in lines:
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        rules.append(parse_rule(ln, dic))
    return Program(rules)


def parse_facts(lines: list[str] | str, dic: Dictionary) -> np.ndarray:
    """Parse ``(s, p, o)`` fact lines into an (n, 3) int32 array."""
    if isinstance(lines, str):
        lines = [ln for ln in lines.splitlines()]
    out = []
    for ln in lines:
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _ATOM_RE.findall(ln)
        if len(m) != 1:
            raise ValueError(f"expected one fact per line: {ln!r}")
        trip = tuple(dic.intern(t) for t in m[0])
        out.append(trip)
    return np.asarray(out, dtype=np.int32).reshape(-1, 3)
