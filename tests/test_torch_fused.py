"""The port's fused round loop against the reference's, exactly.

``TorchEngine()`` runs its rounds through :mod:`repro_torch.core.fused` by
default, as ``JaxEngine(fuse_rounds=True)`` does through
``repro.core.fused``.  On the CPU the port's round body runs eagerly; it
must give the reference's triples, rho and the six counters (and its rule
rewrites) on the paper's example, a small ``claros_like``, the four profile
shapes of ``tests/test_fused.py``, ``merge_like`` (12 constant rules: rho
reaches a rule constant, so the loop exits, the host rewrites the program
and the loop resumes) and seeded random programs; and the port's host loop
(``fuse_rounds=False``) on the same inputs.  Then: capacity growth from
4-row buffers, the contradiction, and the plan signature and constant
tables against the reference's.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import fused as jfused  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.core.materialise import Contradiction as RefContradiction  # noqa: E402
from repro.core.triples import pack  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data.generator import PROFILES as JPROFILES  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro_torch.core import fused, rules  # noqa: E402
from repro_torch.core.engine import Contradiction, TorchEngine  # noqa: E402
from repro_torch.core.terms import DIFFERENT_FROM, SAME_AS  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.data.generator import PROFILES, generate  # noqa: E402

COUNTERS = ("derivations", "rule_applications", "merged_resources",
            "reflexive_added", "rounds", "triples_total", "rule_rewrites",
            "rules_requeued", "full_plan_evals", "sameas_pairs")

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
PROFILE_CUTS = {
    "claros_small": ("claros_like", dict(n_groups=40, n_plain=800)),
    "merge_like": ("merge_like", {}),
}

N_RES = 9
CONSTS = list(range(3, N_RES))
PREDS = CONSTS + [SAME_AS]
VARS = [-1, -2]


def _random_case(seed: int):
    """The shape of tests/test_engine_jax.py's hypothesis test: up to 6
    facts and 2 rules of 1-2 atoms over 6 constants, 2 variables and
    sameAs, differentFrom in heads."""
    rng = np.random.default_rng(100 + seed)
    facts = np.asarray([
        (rng.choice(CONSTS), rng.choice(PREDS), rng.choice(CONSTS))
        for _ in range(rng.integers(1, 7))
    ], np.int32)
    spec = []
    for _ in range(rng.integers(0, 3)):
        body = tuple(
            (int(rng.choice(CONSTS + VARS)), int(rng.choice(PREDS)),
             int(rng.choice(CONSTS + VARS)))
            for _ in range(rng.integers(1, 3))
        )
        body_vars = [t for a in body for t in a if t < 0]
        so = CONSTS + body_vars if body_vars else CONSTS
        spec.append(((int(rng.choice(so)), int(rng.choice(PREDS + [DIFFERENT_FROM])),
                      int(rng.choice(so))), body))
    return facts, spec, N_RES


def _case(name: str):
    """``(facts, rule spec, n_resources)``; both packages' datasets and
    generators make the same facts."""
    if name.startswith("random"):
        return _random_case(int(name.split("-")[1]))
    if name in COMBOS:
        kw, seed = COMBOS[name]
        facts, program, dic = generate(**kw, seed=seed)
        jfacts = jgenerate(**kw, seed=seed)[0]
    elif name in PROFILE_CUTS:
        base, cut = PROFILE_CUTS[name]
        facts, program, dic = generate(**dict(PROFILES[base], **cut))
        jfacts = jgenerate(**dict(JPROFILES[base], **cut))[0]
    else:
        facts, program, dic = getattr(datasets, name)()
        jfacts = getattr(jdata, name)()[0]
    np.testing.assert_array_equal(facts, jfacts)
    return facts, [(r.head, r.body) for r in program.rules], dic.n_resources


def _programs(spec):
    return (rules.Program([rules.Rule(h, b) for h, b in spec]),
            jrules.Program([jrules.Rule(h, b) for h, b in spec]))


def _run(engine, facts, program):
    try:
        return engine.materialise(facts, program)
    except (Contradiction, RefContradiction):
        return "contradiction"


def _same(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    spo, rep, stats = want
    pspo, prep, pstats = got
    assert set(pack(pspo).tolist()) == set(pack(spo).tolist())
    np.testing.assert_array_equal(prep, rep)
    for k in COUNTERS:
        assert getattr(pstats, k) == getattr(stats, k), k


CASES = (["pex", "pex_rule_rewrite", "claros_small", "merge_like"]
         + list(COMBOS) + [f"random-{s}" for s in range(12)])


@pytest.mark.parametrize("name", CASES)
def test_fused_matches_reference_fused_and_host_loop(name):
    facts, spec, n_res = _case(name)
    prog, jprog = _programs(spec)
    cap = 1 << 12 if name in PROFILE_CUTS else 1 << 9
    caps = dict(capacity=cap, bind_cap=cap, out_cap=cap, rewrite_cap=cap)
    want = _run(JaxEngine(n_res, fuse_rounds=True, **caps), facts, jprog)
    eng = TorchEngine(n_res, device="cpu", **caps)
    assert eng.fuse_rounds
    got = _run(eng, facts, prog)
    _same(got, want)
    host = _run(TorchEngine(n_res, device="cpu", fuse_rounds=False, **caps),
                facts, prog)
    _same(host, got)
    if name == "merge_like":
        # rho reached a rule constant: the loop exited, the host rewrote
        # the program, evaluated the exit round again and resumed
        assert got[2].rule_rewrites >= 1
    if not isinstance(got, str):
        # every round was a fused round with one host read
        rounds = eng.last_split["rounds"]
        assert len(rounds) == got[2].rounds
        assert all(r["reads"] == 1 for r in rounds)


@pytest.mark.parametrize("name", ["single_clique", "pex", "merge_like"])
def test_capacity_growth_from_four_rows(name):
    """Restarts through the fused loop grow the capacities the reference's
    fused loop grows, to the same result."""
    if name == "single_clique":
        facts, program, dic = datasets.single_clique(6)
        jf, jp, _ = jdata.single_clique(6)
    elif name == "merge_like":
        facts, program, dic = generate(**dict(PROFILES[name], n_groups=3,
                                              n_plain=12))
        jf, jp, _ = jgenerate(**dict(JPROFILES[name], n_groups=3, n_plain=12))
    else:
        facts, program, dic = datasets.pex()
        jf, jp, _ = jdata.pex()
    caps = dict(capacity=4, bind_cap=4, out_cap=4, rewrite_cap=4)
    eng = TorchEngine(dic.n_resources, device="cpu", **caps)
    ref_eng = JaxEngine(dic.n_resources, fuse_rounds=True, **caps)
    got = eng.materialise(facts, program)
    _same(got, ref_eng.materialise(jf, jp))
    names = ("capacity", "bind_cap", "out_cap", "rewrite_cap")
    assert [getattr(eng, c) for c in names] == [getattr(ref_eng, c) for c in names]
    assert got[2].capacity_retries > 0


def test_contradiction_raised():
    eng = TorchEngine(10, capacity=64, bind_cap=64, out_cap=64,
                      rewrite_cap=64, device="cpu")
    facts = np.array([[5, DIFFERENT_FROM, 6], [5, SAME_AS, 6]], np.int32)
    with pytest.raises(Contradiction):
        eng.materialise(facts, rules.Program([]))


@pytest.mark.parametrize("name", ["pex_rule_rewrite", "merge_like", "dbpedia_ish",
                                  "random-1"])
def test_plan_signature_and_tables_match_reference(name):
    _, spec, _ = _case(name)
    prog, jprog = _programs(spec)
    sig, jsig = fused.forward_plan_signature(prog), jfused.forward_plan_signature(jprog)
    assert len(sig) == len(jsig)
    for (k, plan, slots), (jk, jplan, jslots) in zip(sig, jsig):
        assert (k, slots) == (jk, jslots)
        assert [tuple(vars(s).values()) for s in plan] == [
            tuple(vars(s).values()) for s in jplan]
    for got, want in zip(fused.program_tables(prog), jfused.program_tables(jprog),
                         strict=True):
        np.testing.assert_array_equal(got, np.asarray(want))
    # a rewrite keeps the tables' shapes at the graph's width
    width = fused.program_tables(prog)[2].shape[0]
    rep = np.arange(max(max(prog.constants(), default=0) + 1, 4), dtype=np.int32)
    rewritten, _ = prog.rewrite(np.minimum(rep, 3))
    assert fused.program_tables(rewritten, width)[2].shape == (width,)


def test_one_fused_round_equals_a_host_round():
    """One fused round on a carry made from a fresh state: the flag vector
    reports what the host loop's first round reports."""
    facts, program, dic = datasets.pex()
    eng = TorchEngine(dic.n_resources, capacity=64, bind_cap=64, out_cap=64,
                      rewrite_cap=64, device="cpu")
    state = eng._fresh_state(program)
    cands, valid = eng._pad_cands(facts)
    carry = fused.new_carry(state, cands, valid)
    tables = fused.round_tables(program, state.spo.device)
    fused.forward_round(carry, tables, fused.forward_plan_signature(program),
                        rewrite_cap=64, bind_cap=64, plan_out_cap=64)
    fl = dict(zip(fused.FLAGS, carry["flags"].tolist()))
    host = TorchEngine(dic.n_resources, capacity=64, bind_cap=64, out_cap=64,
                       rewrite_cap=64, device="cpu", fuse_rounds=False)
    hstate = host._fresh_state(program)
    hc, hv = host._pad_cands(facts)
    from repro_torch.core.engine import process_candidates

    out = process_candidates(hstate.spo, hstate.epoch, hstate.marked,
                             hstate.n_used, hstate.rep, hstate.sort_perm,
                             hstate.sorted_keys, hc, hv, 1, 64)
    assert fl["iters"] == 1 and int(carry["r"]) == 1
    assert fl["n_new"] == out[7]["n_new"] and fl["n_pairs"] == out[7]["n_pairs"]
    assert fl["n_reflexive"] == out[7]["n_reflexive"]
    for k in ("spo", "epoch", "marked", "n_used", "rep", "sort_perm", "sorted_keys"):
        assert torch.equal(carry[k], out[["spo", "epoch", "marked", "n_used", "rep",
                                          "sort_perm", "sorted_keys"].index(k)]), k
