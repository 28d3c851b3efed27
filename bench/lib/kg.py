"""The benchmark's own knowledge-graph generator, frozen here so that the
yardstick does not move with the program.

It takes the knobs of the repository's clique-injected generator (the
profiles that stand in for the paper's data sets) and gives the same
rules, the same counts of explicit rows and resources, and the same
structure: duplicate groups that share an inverse-functional ``:idProp``
value (the source of owl:sameAs), spokes on the duplicates, a class
hierarchy, random payload over plain entities, optionally the
``:worksAt`` chain rules, symmetric and transitive ``:sameHomeTown``
groups and rules with an entity constant.  It draws with vectorised NumPy
and makes integer ids directly: ids 0-2 are reserved (owl:sameAs is 1),
the rules' constants come next in the order the rules name them, then
the data's resources in blocks.  The draws differ from the program's
generator; the counts do not.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RESERVED = {"owl:sameAs": 1, "owl:differentFrom": 2}
N_RESERVED = 3
MAX_ID = (1 << 21) - 3  # ids pack into 21 bits a position


@dataclass
class KG:
    facts: np.ndarray        # (n, 3) int32 explicit rows, duplicates kept
    rules: list[str]         # the program as text
    ids: dict[str, int]      # every named resource -> id (the rules' constants first)
    n_resources: int
    members: np.ndarray      # (n_groups, group_size) ids of each duplicate group
    id_prop: int


def rule_text(hierarchy_depth: int = 3, hometown_groups: int = 0,
              chain_rules: bool = False, **_) -> list[str]:
    """The program's rules, without the entity-constant ones."""
    rules = ["(?x, owl:sameAs, ?y) <- (?x, :idProp, ?v) & (?y, :idProp, ?v)"]
    rules += [f"(?x, rdf:type, :C{lvl + 1}) <- (?x, rdf:type, :C{lvl})"
              for lvl in range(hierarchy_depth)]
    if hometown_groups > 0:
        rules += ["(?y, :sameHomeTown, ?x) <- (?x, :sameHomeTown, ?y)",
                  "(?x, :sameHomeTown, ?z) <- (?x, :sameHomeTown, ?y) & "
                  "(?y, :sameHomeTown, ?z)"]
    if chain_rules:
        rules += ["(?x, :colleagueOf, ?z) <- (?x, :worksAt, ?y) & (?z, :worksAt, ?y)",
                  "(?x, :related, ?y) <- (?x, :colleagueOf, ?y)"]
    return rules


def _names_of(rules: list[str]) -> list[str]:
    out = []
    for line in rules:
        for tok in line.replace("(", " ").replace(")", " ").replace(",", " ").split():
            if tok not in ("<-", "&") and not tok.startswith("?"):
                out.append(tok)
    return out


def generate(seed: int, n_groups: int = 200, group_size: int = 4,
             n_spokes_per: int = 3, n_plain: int = 2000, hierarchy_depth: int = 3,
             hometown_groups: int = 0, hometown_size: int = 0,
             chain_rules: bool = False, const_rules: int = 0) -> KG:
    rng = np.random.default_rng(seed)
    rules = rule_text(hierarchy_depth, hometown_groups, chain_rules)
    ids = dict(RESERVED)
    nxt = N_RESERVED

    def intern(name: str) -> int:
        nonlocal nxt
        if name not in ids:
            ids[name] = nxt
            nxt += 1
        return ids[name]

    def block(n: int) -> np.ndarray:
        nonlocal nxt
        out = np.arange(nxt, nxt + n, dtype=np.int32)
        nxt += n
        return out

    for name in _names_of(rules):
        intern(name)
    id_prop, rdf_type = intern(":idProp"), intern("rdf:type")
    spoke, works_at = intern(":spoke"), intern(":worksAt")
    home = intern(":sameHomeTown")
    classes = [intern(f":C{i}") for i in range(hierarchy_depth + 1)]

    # duplicate groups: per group its :idProp value, members, spokes
    g = block(n_groups * (1 + group_size + n_spokes_per)).reshape(n_groups, -1)
    value, members, spokes = g[:, 0], g[:, 1:1 + group_size], g[:, 1 + group_size:]
    parts = [
        np.stack([members.ravel(), np.full(members.size, id_prop),
                  np.repeat(value, group_size)], axis=1),
        np.stack([members.ravel(), np.full(members.size, rdf_type),
                  np.full(members.size, classes[0])], axis=1),
        np.stack([spokes.ravel(), np.full(spokes.size, spoke),
                  members[:, np.arange(n_spokes_per) % group_size].ravel()], axis=1),
    ]
    if const_rules > 0:  # anchored on each group's last (highest-id) member
        intern(":anchored")
        for k in range(min(const_rules, n_groups)):
            anchor = int(members[k, -1])
            ids[f":e{k}_{group_size - 1}"] = anchor
            rules.append(f"(?s, :anchored, :A{k}) <- (?s, :spoke, :e{k}_{group_size - 1})")
            intern(f":A{k}")

    ents = block(max(n_plain // 4, 1))
    orgs = block(max(n_plain // 40, 1))
    props = np.asarray([intern(p) for p in (":knows", ":near", ":partOf")], np.int32)
    parts.append(np.stack([ents[rng.integers(ents.size, size=n_plain)],
                           props[rng.integers(3, size=n_plain)],
                           ents[rng.integers(ents.size, size=n_plain)]], axis=1))
    if chain_rules:
        parts.append(np.stack([ents, np.full(ents.size, works_at),
                               orgs[rng.integers(orgs.size, size=ents.size)]], axis=1))
    people = block(hometown_groups * hometown_size).reshape(hometown_groups,
                                                            hometown_size)
    if hometown_size > 1:
        parts.append(np.stack([people[:, :-1].ravel(),
                               np.full(hometown_groups * (hometown_size - 1), home),
                               people[:, 1:].ravel()], axis=1))
    if nxt - 1 > MAX_ID:
        raise OverflowError(f"{nxt} resources: ids past {MAX_ID} do not pack")
    facts = np.concatenate(parts).astype(np.int32)
    return KG(facts=facts, rules=rules, ids=ids, n_resources=nxt, members=members,
              id_prop=id_prop)


def counts(n_groups: int = 200, group_size: int = 4, n_spokes_per: int = 3,
           n_plain: int = 2000, hierarchy_depth: int = 3, hometown_groups: int = 0,
           hometown_size: int = 0, chain_rules: bool = False,
           const_rules: int = 0) -> dict:
    """Explicit rows and resources of a profile, by formula."""
    constants = len(set(_names_of(rule_text(hierarchy_depth, hometown_groups,
                                            chain_rules)))
                    | {":idProp", "rdf:type", ":spoke", ":worksAt", ":sameHomeTown"}
                    | {f":C{i}" for i in range(hierarchy_depth + 1)}
                    | set(RESERVED))
    consts = min(const_rules, n_groups)
    resources = (N_RESERVED + constants - len(RESERVED)
                 + n_groups * (1 + group_size + n_spokes_per)
                 + (1 + consts if consts else 0)
                 + max(n_plain // 4, 1) + max(n_plain // 40, 1) + 3
                 + hometown_groups * hometown_size)
    explicit = (2 * n_groups * group_size + n_groups * n_spokes_per + n_plain
                + (max(n_plain // 4, 1) if chain_rules else 0)
                + hometown_groups * max(hometown_size - 1, 0))
    return dict(explicit=explicit, resources=resources)
