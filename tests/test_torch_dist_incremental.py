"""Sharded incremental add and delete against the reference, rank by rank.

The seven cells of the reference's mesh matrix
(``tests/test_incremental_spmd.py``: 1, 2 and 4 shards, owner routing at
``route_cap`` 256, whole-rule requeue, the host loops) run on 4 gloo
processes of the port and on 4 fake devices of the reference
(``tests/dist_cases.py``), over a sampled update stream and a merge-heavy
tail.  After the base run and after every event: each rank's eight state
arrays are the reference's shard, and rho, the explicit set, the rewritten
program, the round counter, every ``MatStats`` counter (the retries net of
the base run) and the phase labels are the reference's; the gathered store
is the numpy from-scratch ``materialise_rew``'s; the final store is the same
on every cell; and ``full_plan_evals``, ``remerge_targeted`` and
``rule_rewrites`` move as the reference's own test asserts.
"""

import json

import numpy as np
import pytest

from dist_cases import (
    CELLS, assert_shard_equal, assert_stats_equal, inc_jobs, load, packset,
    run_port, start_reference, wait_reference,
)

N_EVENTS = 6
BY_NAME = {c[0]: c for c in CELLS}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_inc")
    jobs = inc_jobs()
    procs = start_reference(jobs, root / "ref", n_procs=len(jobs))
    try:
        run_port(jobs, root / "port")
    except BaseException:
        for proc, log, _ in procs:
            proc.kill()
            log.close()
        raise
    wait_reference(procs)
    return root


def _load(out, side: str, cell: str, e: int, rank: int | None = None):
    suffix = "" if rank is None else f".r{rank}"
    return load(out / side / f"{cell}-e{e}{suffix}.npz")


@pytest.mark.parametrize("event", range(N_EVENTS + 1))
@pytest.mark.parametrize("cell", list(BY_NAME))
def test_cell_matches_reference_per_shard(out, cell, event):
    D = BY_NAME[cell][1]
    ref = _load(out, "ref", cell, event)
    tag = f"{cell} e{event}"
    for s in range(D):
        got = _load(out, "port", cell, event, s)
        assert_shard_equal(got, ref, D, s, tag)
        assert_stats_equal(got, ref, tag)
        stats, want = (json.loads(str(x["stats"])) for x in (got, ref))
        if event:  # the reference books no base-run restart
            assert (stats["capacity_retries"] - int(got["base_retries"])
                    == want["capacity_retries"]), tag
            assert stats["wide_growth_restarts"] == want["wide_growth_restarts"]
        assert int(got["r"]) == int(ref["r"]), tag
        assert packset(got["explicit"]) == packset(ref["explicit"]), tag
        assert json.loads(str(got["program"])) == json.loads(str(ref["program"]))
        assert json.loads(str(got["caps"])) == json.loads(str(ref["caps"])), tag
        assert json.loads(str(got["labels"])) == json.loads(str(ref["labels"]))
        np.testing.assert_array_equal(got["triples"], ref["triples"], err_msg=tag)
        if event:  # globally, the from-scratch oracle's store and rho
            assert packset(got["triples"]) == packset(ref["scratch"]), tag
            np.testing.assert_array_equal(got["rep"], ref["scratch_rep"])


@pytest.mark.parametrize("cell", list(BY_NAME))
def test_cell_counters_move_as_the_reference_asserts(out, cell):
    """The tail really merged; targeted cells evaluate no full plan after
    the base run and at least one merge-anchored one; the requeue cell
    evaluates full plans."""
    base = json.loads(str(_load(out, "port", cell, 0, 0)["stats"]))
    last = json.loads(str(_load(out, "port", cell, N_EVENTS, 0)["stats"]))
    assert last["rule_rewrites"] > base["rule_rewrites"]
    if BY_NAME[cell][3] == "targeted":
        assert last["full_plan_evals"] == base["full_plan_evals"]
        assert last["remerge_targeted"] >= 1
    else:
        assert last["full_plan_evals"] > base["full_plan_evals"]
    assert last["overdeleted"] and last["suspects_split"]


def test_final_store_is_device_count_invariant(out):
    finals = {cell: frozenset(packset(_load(out, "port", cell, N_EVENTS, 0)
                                      ["triples"])) for cell in BY_NAME}
    assert len(set(finals.values())) == 1, sorted(finals)
