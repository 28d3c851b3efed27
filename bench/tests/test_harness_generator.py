"""The frozen generator's counts against the profiles' formulas, and the
rules' constants in the order the program's parser would give them."""

import numpy as np
import pytest

from bench.lib import kg

UNIPROT = dict(n_groups=2, group_size=2, n_spokes_per=1, hierarchy_depth=2,
               chain_rules=True)
OPENCYC = dict(n_groups=51600, group_size=8, n_spokes_per=2, n_plain=1470000,
               hierarchy_depth=3)


@pytest.mark.parametrize("n_plain", [40, 4000, 100000])
def test_uniprot_explicit_rows(n_plain):
    g = kg.generate(2**31 + 3, n_plain=n_plain, **UNIPROT)
    assert g.facts.shape[0] == 1.25 * n_plain + 10 == kg.counts(n_plain=n_plain,
                                                                **UNIPROT)["explicit"]
    assert g.n_resources == kg.counts(n_plain=n_plain, **UNIPROT)["resources"]


def test_opencyc_at_full_scale():
    g = kg.generate(7, **OPENCYC)
    assert g.facts.shape == (2398800, 3)
    assert g.n_resources == 971865 == kg.counts(**OPENCYC)["resources"]
    assert g.facts.max() < g.n_resources and g.facts.min() > 2


@pytest.mark.parametrize("knobs", [
    dict(n_groups=40, group_size=3, n_spokes_per=2, n_plain=3000, hierarchy_depth=2,
         hometown_groups=4, hometown_size=24),
    dict(n_groups=48, group_size=4, n_spokes_per=3, n_plain=600, hierarchy_depth=1,
         const_rules=12),
    dict(n_groups=300, group_size=6, n_spokes_per=4, n_plain=4000, hierarchy_depth=4),
])
def test_other_profiles_count_as_their_formula(knobs):
    g = kg.generate(1, **knobs)
    c = kg.counts(**knobs)
    assert (g.facts.shape[0], g.n_resources) == (c["explicit"], c["resources"])


def test_same_seed_same_inputs_other_seed_other_draws():
    a, b, c = (kg.generate(s, n_plain=4000, **UNIPROT) for s in (5, 5, 6))
    assert np.array_equal(a.facts, b.facts)
    assert not np.array_equal(a.facts, c.facts)
    assert a.facts.shape == c.facts.shape


def test_constants_come_first_in_rule_order():
    g = kg.generate(0, n_plain=40, **UNIPROT)
    assert g.ids["owl:sameAs"] == 1
    assert [g.ids[n] for n in (":idProp", "rdf:type", ":C1", ":C0", ":C2")] == [3, 4, 5, 6, 7]
    members = g.members.ravel()
    assert (g.facts[np.isin(g.facts[:, 0], members)][:, 1] >= 3).all()
