"""The sharded engine against the reference's ``mesh=`` path, rank by rank.

The port runs in 4 gloo processes on the CPU, with meshes of their first 1,
2 and 4 ranks (``repro_torch.launch.mesh``); the reference runs
``JaxEngine(mesh=make_engine_mesh(D))`` on 4 fake CPU devices in
subprocesses (``tests/dist_cases.py``).  Held exactly:

* the collectives keep rank order (JAX's tiled order) on 1, 2 and 4
  ranks, and a backend that cannot carry a tensor's device raises;
* ``_route_rows`` in each mode (gather and own, the bucket exchange, a
  forced bucket overflow) gives every rank the reference's shard;
* base REW on ``pex``, ``pex_rule_rewrite``, ``single_clique(6)`` and
  ``uobm_like`` at D 1, 2 and 4, gathered and routed (``route_cap`` 2^11),
  under the fused and the host loop, and two runs that grow ``route_cap``
  from 4: each rank's eight state arrays are the reference's shard, and
  rho, every ``MatStats`` counter, the round counter, the capacities and
  the capacity restarts are the reference's; the gathered triples are the
  same at every D.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dist_cases import (
    ROUTE_CASES, assert_shard_equal, assert_stats_equal, base_jobs, load,
    packset, run_port, shard, start_reference, wait_reference,
)
from repro_torch.core import collectives as coll

JOBS = base_jobs()
BY_NAME = {j["name"]: j for j in JOBS}


def _cost(job) -> int:
    return (job["ds"] == "uobm_like") * (2 + (job["route_cap"] is not None))


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    ref_jobs = [dict(kind="route")] + sorted(JOBS, key=_cost, reverse=True)
    procs = start_reference(ref_jobs, root / "ref", n_procs=8)
    try:
        run_port([dict(kind="coll"), dict(kind="route")] + JOBS, root / "port")
    except BaseException:
        for proc, log, _ in procs:
            proc.kill()
            log.close()
        raise
    wait_reference(procs)
    return root


# -- collectives -------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4])
def test_collectives_keep_rank_order(out, D):
    got = [load(out / "port" / f"coll-d{D}.r{r}.npz") for r in range(D)]
    x = [np.arange(6).reshape(3, 2) + 100 * r for r in range(D)]
    flags = [np.asarray([r % 2 == 0, False, True]) for r in range(D)]
    for r, g in enumerate(got):
        assert g["index"].tolist() == [r]
        np.testing.assert_array_equal(g["gather"], np.concatenate(x))
        np.testing.assert_array_equal(g["gather_bool"], np.concatenate(flags))
        assert g["gather_bool"].dtype == bool
        # rank r gets block r of every rank, by source rank
        want = np.concatenate([np.arange(D * 2).reshape(D, 2)[r] + 10 * s
                               for s in range(D)])
        np.testing.assert_array_equal(g["a2a"].reshape(-1), want)
        np.testing.assert_array_equal(g["psum"], [sum(range(D)), D])
        np.testing.assert_array_equal(g["psum_bool"], np.sum(flags, axis=0))
        np.testing.assert_array_equal(g["pany"], np.any(flags, axis=0))
        counts = json.loads(str(g["counts"]))
        assert counts["calls"] == {"all_gather": 2, "all_to_all": 1,
                                   "all_reduce": 3}


def _mesh(backend):
    return SimpleNamespace(backend=backend, world=2, rank=0, group=None)


def test_backend_carries_or_stages_or_raises():
    """gloo carries CPU and CUDA tensors itself (nothing is staged through
    the host); NCCL carries CUDA only; another pairing raises before any
    collective is called."""
    cpu = torch.zeros(2)
    cuda = SimpleNamespace(device=torch.device("cuda"))
    for op in ("all_gather", "all_reduce", "all_to_all"):
        coll._check(op, cpu, _mesh("gloo"))
        coll._check(op, cuda, _mesh("gloo"))
        coll._check(op, cuda, _mesh("nccl"))
        with pytest.raises(ValueError):
            coll._check(op, cpu, _mesh("nccl"))
        with pytest.raises(ValueError):
            coll._check(op, cuda, _mesh("mpi"))
    for fn in (coll.all_gather, coll.all_to_all, coll.psum, coll.pany):
        with pytest.raises(ValueError, match="does not carry cpu"):
            fn(torch.zeros(2, dtype=torch.int32), _mesh("nccl"))


def test_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_engine_mesh, mesh_size

    with pytest.raises(RuntimeError):
        make_engine_mesh(2)
    assert mesh_size(None) == 1
    assert mesh_size(_mesh("gloo")) == 2


# -- _route_rows ---------------------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in ROUTE_CASES])
def test_route_rows_is_the_reference(out, case):
    _, D, _n, rc, _k = next(c for c in ROUTE_CASES if c[0] == case)
    ref = load(out / "ref" / f"route-{case}.npz")
    overflow = []
    for s in range(D):
        got = load(out / "port" / f"route-{case}.r{s}.npz")
        for k in ("stream", "flags", "valid"):
            np.testing.assert_array_equal(
                got[k], shard(ref, k, D, s), err_msg=f"{case} shard {s} {k}")
        assert bool(got["overflow"][0]) == bool(ref["overflow"][s])
        overflow.append(bool(got["overflow"][0]))
    assert any(overflow) == case.startswith("overflow")


# -- base REW ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BY_NAME))
def test_base_rew_is_the_reference(out, name):
    job = BY_NAME[name]
    D = job["D"]
    ref = load(out / "ref" / f"{name}.npz")
    grows = json.loads(str(ref["grows"]))
    for s in range(D):
        got = load(out / "port" / f"{name}.r{s}.npz")
        np.testing.assert_array_equal(got["facts"], ref["facts"])
        assert_shard_equal(got, ref, D, s, name)
        assert_stats_equal(got, ref, name)
        assert int(got["r"]) == int(ref["r"])
        assert json.loads(str(got["caps"])) == json.loads(str(ref["caps"]))
        # the reference books no base-run restart; the port books each
        assert json.loads(str(got["stats"]))["capacity_retries"] == len(grows)
        np.testing.assert_array_equal(got["triples"], ref["triples"])
        assert json.loads(str(got["report"])) == []
        assert json.loads(str(got["split"]))["graphs"] is False
    if "rc4" in name:
        assert "route" in grows


@pytest.mark.parametrize("name", list(BY_NAME))
def test_each_rank_counts_its_dispatches(out, name):
    """Every rank counts the units it ran (restarted attempts included):
    the same families and counts on each rank, no graph captured (the
    rounds run eagerly), and on a run without restarts one ``fforward`` a
    fused round or one ``process`` a host round."""
    job = BY_NAME[name]
    got = [load(out / "port" / f"{name}.r{s}.npz") for s in range(job["D"])]
    counts = [json.loads(str(g["dispatches"])) for g in got]
    assert all(c == counts[0] for c in counts)
    assert all(int(g["captures"]) == 0 for g in got)
    stats = json.loads(str(got[0]["stats"]))
    fused, host = counts[0].get("fforward", 0), counts[0].get("process", 0)
    if not job["fuse"]:
        assert fused == 0
    if not stats["capacity_retries"]:
        assert fused + host == stats["rounds"]


@pytest.mark.parametrize("mode", ["gather", "routed"])
@pytest.mark.parametrize("loop", ["fused", "host"])
@pytest.mark.parametrize("ds", ["pex", "pex_rule_rewrite", "clique6", "uobm_like"])
def test_gathered_triples_are_device_count_invariant(out, ds, mode, loop):
    sets = {D: packset(load(out / "port" / f"{ds}-d{D}-{mode}-{loop}.r0.npz")
                       ["triples"]) for D in (1, 2, 4)}
    assert sets[1] == sets[2] == sets[4]
    reps = [load(out / "port" / f"{ds}-d{D}-{mode}-{loop}.r0.npz")["rep"]
            for D in (1, 2, 4)]
    np.testing.assert_array_equal(reps[0], reps[1])
    np.testing.assert_array_equal(reps[0], reps[2])


def test_from_config_honours_route_cap():
    from repro_torch.configs.sameas_rew import REDUCED
    from repro_torch.core.engine import TorchEngine

    eng = TorchEngine.from_config(REDUCED, device="cpu")
    assert (eng.route_cap, eng.n_shards, eng.mesh, eng._route) == (
        REDUCED.route_cap, 1, None, None)
    assert TorchEngine.from_config(REDUCED, device="cpu",
                                   route_cap=None).route_cap is None
