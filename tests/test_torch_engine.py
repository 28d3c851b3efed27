"""The port's REW engine against the reference's ``JaxEngine``, exactly.

(a) State carried across: a reference fixpoint state goes through
    ``state_from_arrays``, then one ``eval_plan`` per plan of the program
    and one ``process_candidates`` on a seeded candidate batch give the same
    arrays and flags in both packages.
(b) The slice on the paper's small datasets, against the reference with
    its Pallas dedup kernel (``use_kernel=True``); the generator profiles
    are in ``test_torch_engine_profiles.py``.
(c) Capacity growth from 4-row buffers; (d) the differentFrom contradiction.

Each run pins the host loop on both sides (``fuse_rounds=False``); the fused
loop is held to the reference's in ``test_torch_fused.py``.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import engine_jax as jeng  # noqa: E402
from repro.core.terms import DIFFERENT_FROM, SAME_AS  # noqa: E402
from repro.core.triples import pack  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data.generator import PROFILES, generate as jgenerate  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.rules import Program  # noqa: E402
from repro_torch.data import datasets  # noqa: E402

COUNTERS = ("derivations", "rule_applications", "merged_resources",
            "reflexive_added", "rounds", "triples_total")


def _claros_small():
    kw = dict(PROFILES["claros_like"], n_groups=40, n_plain=800)
    return jgenerate(**kw)


@pytest.fixture(scope="module", params=["pex", "claros_like"])
def ref_state(request):
    facts, program, dic = (jdata.pex() if request.param == "pex"
                           else _claros_small())
    eng = jeng.JaxEngine(dic.n_resources, capacity=2048, bind_cap=2048,
                         out_cap=2048, rewrite_cap=2048, fuse_rounds=False)
    state = eng.materialise_state(facts, program)
    arrays = {name: np.asarray(getattr(state, name))
              for name in engine._STATE_ARRAYS}
    return state, arrays


def _port_state(ref_state):
    state, arrays = ref_state
    program = Program(list(state.program.rules))
    return engine.state_from_arrays(arrays, program, state.r, device="cpu")


def test_state_round_trip(ref_state):
    _, arrays = ref_state
    back = engine.state_to_arrays(_port_state(ref_state))
    assert back.keys() == arrays.keys()
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr.reshape(back[name].shape))
    assert engine.index_invariant_report(_port_state(ref_state)) == []


@pytest.mark.parametrize("caps", [16, 1024])
def test_eval_plan_matches(ref_state, caps):
    state, arrays = ref_state
    port = _port_state(ref_state)
    for rule in state.program.rules:
        atom_consts = np.asarray(
            [[0 if t < 0 else t for t in atom] for atom in rule.body], np.int32
        )
        head_consts = np.asarray([0 if t < 0 else t for t in rule.head], np.int32)
        head_slots = tuple(t if t < 0 else None for t in rule.head)
        for full in (False, True):
            ref_plans = jeng.build_plans(rule, full=full)
            plans = engine.build_plans(rule, full=full)
            for ref_plan, plan in zip(ref_plans, plans, strict=True):
                assert [tuple(vars(s).values()) for s in ref_plan] == [
                    tuple(vars(s).values()) for s in plan
                ]
                for r in (2, state.r, state.r + 1):
                    with jax.enable_x64(True):
                        want = jeng.eval_plan(
                            *(jnp.asarray(arrays[k]) for k in (
                                "spo", "epoch", "marked", "tomb",
                                "sorted_keys", "sort_perm")),
                            jnp.asarray(r, jnp.int32), jnp.asarray(atom_consts),
                            jnp.asarray(head_consts), tuple(ref_plan),
                            head_slots, caps, caps,
                        )
                    got = engine.eval_plan(
                        port.spo, port.epoch, port.marked, port.sorted_keys,
                        port.sort_perm, r, atom_consts.tolist(),
                        head_consts.tolist(), tuple(plan), head_slots, caps,
                        caps,
                    )
                    for g, w in zip(got, want, strict=True):
                        np.testing.assert_array_equal(
                            g.numpy().reshape(-1), np.asarray(w).reshape(-1)
                        )


def _candidates(arrays, n_res, width, seed):
    """Existing rows, new rows over known resources, sameAs pairs, padding."""
    rng = np.random.default_rng(seed)
    live = arrays["spo"][(arrays["epoch"] >= 0) & ~arrays["marked"]]
    res = np.unique(live)
    k = width // 4
    old = live[rng.integers(0, live.shape[0], k)]
    new = rng.choice(res, (k, 3))
    pairs = np.stack([rng.choice(res, k), np.full(k, SAME_AS), rng.choice(res, k)], 1)
    rows = np.concatenate([old, new, pairs]).astype(np.int32)
    cands = np.zeros((width, 3), np.int32)
    cands[: rows.shape[0]] = rows
    return cands, np.arange(width) < rows.shape[0]


def test_process_candidates_matches(ref_state):
    state, arrays = ref_state
    cands, valid = _candidates(arrays, state.n_res, 256, seed=state.r)
    r = state.r + 1
    with jax.enable_x64(True):
        want = jeng.process_candidates(
            *(jnp.asarray(arrays[k]) for k in (
                "spo", "epoch", "marked", "n_used", "rep", "sort_perm",
                "sorted_keys")),
            jnp.asarray(cands), jnp.asarray(valid), jnp.asarray(r, jnp.int32),
            rewrite_cap=1024,
        )
    port = _port_state(ref_state)
    got = engine.process_candidates(
        port.spo, port.epoch, port.marked, port.n_used, port.rep,
        port.sort_perm, port.sorted_keys, torch.from_numpy(cands),
        torch.from_numpy(valid), r, rewrite_cap=1024,
    )
    for g, w in zip(got[:7], want[:7], strict=True):
        np.testing.assert_array_equal(g.numpy().reshape(-1), np.asarray(w).reshape(-1))
    flags, ref_flags = got[7], {k: np.asarray(v) for k, v in want[7].items()}
    for name in ("rep_changed", "contradiction", "ov_rewrite", "ov_store",
                 "n_new", "n_pairs", "n_marked", "n_reflexive"):
        assert flags[name] == ref_flags[name].reshape(-1)[0], name
    np.testing.assert_array_equal(flags["delta_valid"].numpy(),
                                  ref_flags["delta_valid"])
    np.testing.assert_array_equal(
        flags["delta_rows"][flags["delta_valid"]].numpy(),
        ref_flags["delta_rows"][ref_flags["delta_valid"]],
    )
    # the batch exercised merging and the store sweep
    assert flags["rep_changed"] and flags["n_marked"] > 0


def _same_result(ref_out, port_out):
    spo, rep, stats = ref_out
    pspo, prep, pstats = port_out
    assert set(pack(spo).tolist()) == set(pack(pspo).tolist())
    np.testing.assert_array_equal(prep[prep], prep)  # state_rep is compressed
    np.testing.assert_array_equal(prep, rep)
    for k in COUNTERS:
        assert getattr(pstats, k) == getattr(stats, k), k


@pytest.mark.parametrize("name", ["pex", "pex_rule_rewrite", "single_clique"])
def test_slice_matches_reference_with_pallas_dedup(name):
    args = (6,) if name == "single_clique" else ()
    facts, program, dic = getattr(jdata, name)(*args)
    pfacts, pprogram, pdic = getattr(datasets, name)(*args)
    np.testing.assert_array_equal(pfacts, facts)
    ref = jeng.JaxEngine(dic.n_resources, capacity=256, bind_cap=256,
                         out_cap=256, rewrite_cap=256, use_kernel=True,
                         fuse_rounds=False).materialise(facts, program)
    eng = engine.TorchEngine(pdic.n_resources, capacity=256, bind_cap=256,
                             out_cap=256, rewrite_cap=256, device="cpu",
                             fuse_rounds=False)
    _same_result(ref, eng.materialise(pfacts, pprogram))


@pytest.mark.parametrize("name", ["single_clique", "pex"])
def test_capacity_growth_from_four_rows(name):
    """Restarts grow exactly the capacities the reference grows."""
    args = (6,) if name == "single_clique" else ()
    facts, program, dic = getattr(datasets, name)(*args)
    eng = engine.TorchEngine(dic.n_resources, capacity=4, bind_cap=4,
                             out_cap=4, rewrite_cap=4, device="cpu",
                             fuse_rounds=False)
    got = eng.materialise(facts, program)
    jf, jp, jd = getattr(jdata, name)(*args)
    ref_eng = jeng.JaxEngine(jd.n_resources, capacity=4, bind_cap=4, out_cap=4,
                             rewrite_cap=4, fuse_rounds=False)
    _same_result(ref_eng.materialise(jf, jp), got)
    caps = ("capacity", "bind_cap", "out_cap", "rewrite_cap")
    assert [getattr(eng, c) for c in caps] == [getattr(ref_eng, c) for c in caps]
    assert got[2].capacity_retries > 0


def test_contradiction_raised():
    eng = engine.TorchEngine(10, capacity=64, bind_cap=64, out_cap=64,
                             rewrite_cap=64, device="cpu", fuse_rounds=False)
    facts = np.array([[5, DIFFERENT_FROM, 6], [5, SAME_AS, 6]], np.int32)
    with pytest.raises(engine.Contradiction):
        eng.materialise(facts, Program([]))
