"""The plain reference on frozen data: the paper's running example, single
cliques, a clique with spokes; and its controls."""

import numpy as np
import torch

from bench.reference import rew

SA = 1
# the paper's P_ex (section 3): rules (R) and (S), facts (F1)-(F3)
PEX_IDS = {"owl:sameAs": 1, "owl:differentFrom": 2, ":USA": 3, ":Obama": 4,
           ":presidentOf": 5, ":USPresident": 6, ":US": 7, ":America": 8}
PEX_RULES = ["(?x, owl:sameAs, :USA) <- (:Obama, :presidentOf, ?x)",
             "(?x, owl:sameAs, :Obama) <- (?x, :presidentOf, :USA)"]
PEX_FACTS = np.array([[6, 5, 7], [4, 5, 8], [4, 5, 7]], np.int32)


def rows(keys):
    return {tuple(r) for r in rew.unpack(keys).tolist()}


def test_running_example_end_state():
    keys, rho = rew.materialise(PEX_FACTS, PEX_RULES, PEX_IDS, 9)
    # {USA, US, America} -> USA (3), {Obama, USPresident} -> Obama (4)
    assert rho.tolist() == [0, 1, 2, 3, 4, 5, 4, 3, 3]
    assert rows(keys) == {(4, 5, 3), (4, SA, 4), (3, SA, 3), (5, SA, 5), (SA, SA, SA)}


def test_single_clique_by_explicit_links():
    ids = {"owl:sameAs": 1, "owl:differentFrom": 2}
    facts = np.array([[3 + i, SA, 4 + i] for i in range(5)], np.int32)
    keys, rho = rew.materialise(facts, [], ids, 9)
    assert rho.tolist() == [0, 1, 2, 3, 3, 3, 3, 3, 3]
    assert rows(keys) == {(3, SA, 3), (SA, SA, SA)}


def test_clique_with_spokes_keeps_one_copy_a_spoke():
    ids = {"owl:sameAs": 1, "owl:differentFrom": 2, ":spoke": 10}
    facts = np.array([[3, SA, 4], [4, SA, 5], [11, 10, 5], [12, 10, 4]], np.int32)
    keys, rho = rew.materialise(facts, [], ids, 13)
    assert rho[[3, 4, 5]].tolist() == [3, 3, 3]
    assert rows(keys) == {(11, 10, 3), (12, 10, 3), (3, SA, 3), (11, SA, 11),
                          (12, SA, 12), (10, SA, 10), (SA, SA, SA)}


def test_join_rule_and_hierarchy():
    ids = {"owl:sameAs": 1, "owl:differentFrom": 2, ":worksAt": 3, ":colleagueOf": 4,
           "rdf:type": 5, ":C0": 6, ":C1": 7}
    rules = ["(?x, :colleagueOf, ?z) <- (?x, :worksAt, ?y) & (?z, :worksAt, ?y)",
             "(?x, rdf:type, :C1) <- (?x, rdf:type, :C0)"]
    facts = np.array([[10, 3, 20], [11, 3, 20], [12, 3, 21], [10, 5, 6]], np.int32)
    keys, _ = rew.materialise(facts, rules, ids, 22)
    got = rows(keys)
    assert {(10, 4, 11), (11, 4, 10), (10, 4, 10), (12, 4, 12), (10, 5, 7)} <= got
    assert (10, 4, 12) not in got


def test_controls_differ_from_the_reference():
    keys, rho = rew.materialise(PEX_FACTS, PEX_RULES, PEX_IDS, 9)
    stale, _ = rew.materialise(PEX_FACTS, PEX_RULES, PEX_IDS, 9, sweep=False)
    assert not torch.equal(stale, keys)  # outdated facts kept
    left, _ = rew.delete_without_retraction(keys, rho, PEX_FACTS[:1])
    want, _ = rew.materialise(PEX_FACTS[1:], PEX_RULES, PEX_IDS, 9)
    assert not torch.equal(left, want)
