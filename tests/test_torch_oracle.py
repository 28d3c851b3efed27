"""The port's host oracle against the reference's, and Theorem 1 on the
port's engine.

``repro_torch.core.materialise`` (with ``axiom``, ``seminaive`` and the
numpy ``TripleArena``) is a copy of ``repro.core.materialise``: the AX
baseline, the host REW and the Theorem 1 oracle (``expand``,
``check_theorem1``).  On the paper's example, single cliques, cliques with
spokes, the four profile shapes of ``tests/test_fused.py`` and seeded
random programs, both packages give the same triples (in the same arena
order), rho, counters and expansion; the contradictions raise in both
modes.  Then Theorem 1 holds on ``TorchEngine(device="cpu")`` results under
the fused loop and the host loop.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import materialise as jmat  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro_torch.core import materialise as mat  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.core.engine import Contradiction as EngineContradiction  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.terms import DIFFERENT_FROM, SAME_AS  # noqa: E402
from repro_torch.core.triples import TripleArena  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.data.generator import generate  # noqa: E402

# the profile shapes of tests/test_fused.py's _COMBOS
COMBOS = {
    "clique_ish": (dict(n_groups=1, group_size=5, n_spokes_per=2, n_plain=8,
                        hierarchy_depth=0), 3),
    "chain_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=25,
                       hierarchy_depth=3), 5),
    "dbpedia_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=30,
                         hierarchy_depth=1, chain_rules=True), 7),
    "uobm_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=15,
                      hierarchy_depth=1, hometown_groups=1, hometown_size=5), 9),
}

N_RES = 10  # ids 0..9; 3..9 are plain resources
CONSTS = list(range(3, N_RES))
PREDS = CONSTS + [SAME_AS]
VARS = [-1, -2, -3]


def _random_case(seed: int):
    """A random program and facts in the shape of tests/test_theorem1.py:
    up to 8 facts, 3 rules of 1-2 atoms, no differentFrom."""
    rng = np.random.default_rng(seed)
    facts = np.asarray([
        (rng.choice(CONSTS), rng.choice(PREDS), rng.choice(CONSTS))
        for _ in range(rng.integers(1, 9))
    ], np.int32)
    spec = []
    for _ in range(rng.integers(0, 4)):
        body = tuple(
            (int(rng.choice(CONSTS + VARS)), int(rng.choice(PREDS)),
             int(rng.choice(CONSTS + VARS)))
            for _ in range(rng.integers(1, 3))
        )
        body_vars = [t for a in body for t in a if t < 0]
        so = CONSTS + body_vars if body_vars else CONSTS
        spec.append(((int(rng.choice(so)), int(rng.choice(PREDS)),
                      int(rng.choice(so))), body))
    return facts, spec, N_RES


def _case(name: str):
    """``(facts, rule spec, n_resources)`` of a named input; the port's and
    the reference's datasets and generators make the same facts."""
    if name.startswith("random"):
        return _random_case(int(name.split("-")[1]))
    if name in COMBOS:
        kw, seed = COMBOS[name]
        facts, program, dic = generate(**kw, seed=seed)
        jfacts = jgenerate(**kw, seed=seed)[0]
    else:
        fn, *args = name.split("-")
        args = [int(a) for a in args]
        facts, program, dic = getattr(datasets, fn)(*args)
        jfacts = getattr(jdata, fn)(*args)[0]
    np.testing.assert_array_equal(facts, jfacts)
    return facts, [(r.head, r.body) for r in program.rules], dic.n_resources


def _programs(spec):
    return (rules.Program([rules.Rule(h, b) for h, b in spec]),
            jrules.Program([jrules.Rule(h, b) for h, b in spec]))


CASES = (["pex", "pex_rule_rewrite", "single_clique-2", "single_clique-5",
          "single_clique-9", "clique_with_spokes-3-2",
          "clique_with_spokes-6-4"]
         + list(COMBOS) + [f"random-{s}" for s in range(12)])


def _same_result(got, want):
    np.testing.assert_array_equal(got.triples(), want.triples())
    np.testing.assert_array_equal(got.rep, want.rep)
    assert [r.head for r in got.program] == [r.head for r in want.program]
    assert [r.body for r in got.program] == [r.body for r in want.program]
    g, w = dataclasses.asdict(got.stats), dataclasses.asdict(want.stats)
    for k, v in g.items():
        if k != "wall_seconds" and k in w:
            assert v == w[k], k


@pytest.mark.parametrize("name", CASES)
def test_ax_rew_and_oracle_match_reference(name):
    facts, spec, n_res = _case(name)
    prog, jprog = _programs(spec)
    ax, jax_ = mat.materialise_ax(facts, prog, n_res), jmat.materialise_ax(facts, jprog, n_res)
    rew, jrew = mat.materialise_rew(facts, prog, n_res), jmat.materialise_rew(facts, jprog, n_res)
    _same_result(ax, jax_)
    _same_result(rew, jrew)
    assert mat.expand(rew.triples(), rew.rep) == jmat.expand(jrew.triples(), jrew.rep)
    mat.check_theorem1(rew, ax)
    # the oracle rejects what the reference's rejects: a store missing a fact
    if rew.triples().shape[0] > 1:
        cut = mat.MatResult(TripleArena(), rew.rep, rew.program, rew.stats)
        cut.arena.add_batch(rew.triples()[1:])
        jcut = jmat.MatResult(cut.arena, jrew.rep, jrew.program, jrew.stats)
        outcomes = []
        for check, res, ref_ax in ((mat.check_theorem1, cut, ax),
                                   (jmat.check_theorem1, jcut, jax_)):
            try:
                check(res, ref_ax)
                outcomes.append("holds")
            except AssertionError:
                outcomes.append("fails")
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("mode", ["AX", "REW"])
@pytest.mark.parametrize("rows, raises", [
    ([[5, DIFFERENT_FROM, 5]], True),
    ([[5, DIFFERENT_FROM, 6], [5, SAME_AS, 6]], True),
    ([[5, DIFFERENT_FROM, 6], [7, SAME_AS, 6]], False),
], ids=["direct", "via-merge", "none"])
def test_contradiction_both_modes(mode, rows, raises):
    facts = np.asarray(rows, np.int32)
    outcomes = []
    for m, prog in ((mat, rules.Program([])), (jmat, jrules.Program([]))):
        try:
            m.materialise(facts, prog, N_RES, mode=mode)
            outcomes.append(False)
        except m.Contradiction:
            outcomes.append(True)
    assert outcomes == [raises, raises]
    assert EngineContradiction is mat.Contradiction


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "host-loop"])
@pytest.mark.parametrize("name", ["pex", "pex_rule_rewrite",
                                  "clique_with_spokes-6-4", "dbpedia_ish",
                                  "uobm_ish", "random-3", "random-7"])
def test_theorem1_on_engine_results(name, fuse):
    facts, spec, n_res = _case(name)
    prog, _ = _programs(spec)
    eng = TorchEngine(n_res, capacity=512, bind_cap=512, out_cap=512,
                      rewrite_cap=512, device="cpu", fuse_rounds=fuse)
    spo, rep, stats = eng.materialise(facts, prog)
    arena = TripleArena()
    arena.add_batch(spo)
    res = mat.MatResult(arena, rep, prog, stats)
    ax = mat.materialise_ax(facts, prog, n_res)
    mat.check_theorem1(res, ax)
    # and the engine stores what the host REW stores
    host = mat.materialise_rew(facts, prog, n_res)
    assert set(map(tuple, host.triples().tolist())) == set(map(tuple, spo.tolist()))
    np.testing.assert_array_equal(host.rep, rep)
