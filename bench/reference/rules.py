"""Datalog rules as text, parsed for the plain reference.

A rule is ``(h) <- (b1) & (b2) ...``; a term is a variable ``?x`` or a
resource name, which ``ids`` maps to its integer id.  An atom becomes three
ints: a resource id (>= 0) or a variable (-1, -2, ... in order of first
appearance in the rule, head first).  Nothing here is shared with the
program under test.
"""

from __future__ import annotations

import re

SAME_AS = 1  # owl:sameAs: the id every side reserves for it

_ATOM = re.compile(r"\(\s*([^,()\s]+)\s*,\s*([^,()\s]+)\s*,\s*([^,()\s]+)\s*\)")


def parse_rule(text: str, ids: dict[str, int]) -> tuple[tuple, tuple]:
    """``(head, body)``: the head atom and the tuple of body atoms."""
    head_text, arrow, body_text = text.partition("<-")
    if not arrow:
        raise ValueError(f"no '<-' in rule {text!r}")
    names: dict[str, int] = {}

    def term(tok: str) -> int:
        if tok.startswith("?"):
            return names.setdefault(tok, -(len(names) + 1))
        if tok not in ids:
            raise KeyError(f"resource {tok!r} of rule {text!r} has no id")
        return ids[tok]

    heads = _ATOM.findall(head_text)
    body = tuple(tuple(term(t) for t in m) for m in _ATOM.findall(body_text))
    if len(heads) != 1 or not body:
        raise ValueError(f"want one head atom and a body: {text!r}")
    head = tuple(term(t) for t in heads[0])
    if not {t for t in head if t < 0} <= {t for a in body for t in a if t < 0}:
        raise ValueError(f"a head variable is not bound by the body: {text!r}")
    return head, body


def parse_rules(lines: list[str], ids: dict[str, int]) -> list[tuple[tuple, tuple]]:
    return [parse_rule(line, ids) for line in lines
            if line.strip() and not line.strip().startswith("#")]
