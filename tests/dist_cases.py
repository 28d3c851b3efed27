"""Shared by the sharded-engine differentials (``tests/test_torch_dist*.py``).

Two sides run each case and write ``.npz`` files that the tests compare:

* the reference: ``JaxEngine(mesh=make_engine_mesh(D))`` on fake CPU
  devices, in subprocesses started by :func:`start_reference` (``python
  tests/dist_cases.py JOBS OUT``; ``XLA_FLAGS`` gives each 4 devices before
  jax is imported, and the jax 0.9 shim is set before ``repro`` is);
* the port: ``TorchEngine(mesh=...)`` on 4 gloo processes
  (:func:`run_port`, through ``repro_torch.launch.mesh.spawn``, rendezvous
  through a ``FileStore`` in the test's directory), whose meshes of 1, 2
  and 4 ranks are the first ranks of the 4.

A job is a dict: ``kind`` "base" (a base REW run), "route" (the
``_route_rows`` cases), "inc" (a cell of the incremental mesh matrix of
``tests/test_incremental_spmd.py``, dumped after the base run and after
every event) or "coll" (the collectives, port only).  This module imports
neither jax nor ``repro`` at its top: the port's processes import it too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("spo", "epoch", "marked", "tomb", "n_used", "rep", "sort_perm",
          "sorted_keys")
CAP_ATTRS = ("capacity", "bind_cap", "out_cap", "rewrite_cap", "route_cap",
             "pair_cap", "delta_out", "delta_bind", "delta_rewrite")
# the counters a read of the store sets, the wall and the host arena bytes
SKIP = ("mode", "wall_seconds", "memory_bytes", "triples_unmarked",
        "capacity_retries", "wide_growth_restarts")
TIMEOUT_S = 600


# -- the cases -----------------------------------------------------------------

def base_jobs() -> list[dict]:
    """Base REW: four datasets x D 1/2/4 x gather/routed x fused/host
    loop, and two runs that grow ``route_cap`` from 4."""
    jobs = []
    for ds in ("pex", "pex_rule_rewrite", "clique6", "uobm_like"):
        cap = 1 << 13 if ds == "uobm_like" else 1 << 10
        for D in (1, 2, 4):
            for mode in ("gather", "routed"):
                for loop in ("fused", "host"):
                    jobs.append(dict(
                        kind="base", name=f"{ds}-d{D}-{mode}-{loop}", ds=ds,
                        D=D, cap=cap, route_cap=1 << 11 if mode == "routed" else None,
                        fuse=loop == "fused"))
    for D, loop in ((2, "fused"), (4, "host")):
        jobs.append(dict(kind="base", name=f"pex_rule_rewrite-d{D}-rc4-{loop}",
                         ds="pex_rule_rewrite", D=D, cap=1 << 10, route_cap=4,
                         fuse=loop == "fused"))
    return jobs


ROUTE_CASES = [  # (name, D, rows per shard, route_cap, side columns)
    ("gather-d2", 2, 48, None, 2), ("gather-d4", 4, 24, None, 0),
    ("routed-d2", 2, 48, 64, 2), ("routed-d4", 4, 24, 32, 0),
    ("overflow-d2", 2, 48, 5, 2), ("overflow-d4", 4, 24, 3, 1),
]


def route_inputs(name: str):
    """The global inputs of a ``_route_rows`` case: (D * n, 3) int32 rows
    with ids below 40 (so owners repeat), (D * n, k) side columns or None,
    and a validity with a third of the rows off."""
    _, D, n, _rc, k = next(c for c in ROUTE_CASES if c[0] == name)
    rng = np.random.default_rng(sum(map(ord, name)))
    stream = rng.integers(0, 40, size=(D * n, 3)).astype(np.int32)
    flags = rng.integers(0, 9, size=(D * n, k)).astype(np.int32) if k else None
    valid = rng.random(D * n) > 1 / 3
    return stream, flags, valid


CELLS = [  # tests/test_incremental_spmd.py's mesh matrix
    ("m1", 1, None, "targeted", True),
    ("m2", 2, None, "targeted", True),
    ("m4", 4, None, "targeted", True),
    ("m4_routed", 4, 256, "targeted", True),
    ("m2_requeue", 2, None, "requeue", True),
    ("m2_nofuse", 2, None, "targeted", False),
    ("m4_routed_nofuse", 4, 256, "targeted", False),
]


def inc_jobs() -> list[dict]:
    return [dict(kind="inc", name=name, D=D, route_cap=rc, rederive=rmode,
                 fuse=fuse) for name, D, rc, rmode, fuse in CELLS]


def inc_case(pkg):
    """The mesh matrix's data: ``(facts, program, n_resources, events)``
    from ``pkg``'s generator (``repro`` or ``repro_torch``), with its
    merge-heavy tail (join the two constant-rule entities, then split
    them again)."""
    gen = __import__(f"{pkg}.data.generator", fromlist=["generate"])
    facts, prog, dic = gen.generate(n_groups=2, group_size=3, n_spokes_per=1,
                                    n_plain=15, hierarchy_depth=1,
                                    const_rules=2, seed=3)
    events = gen.sample_update_stream(facts, dic, n_events=4, batch=8, seed=3)
    idp = dic.id_of(":idProp")
    mv = dic.intern(":mv0")
    merge = np.asarray([[dic.id_of(":e1_2"), idp, mv],
                        [dic.id_of(":e0_2"), idp, mv]], np.int32)
    return facts, prog, dic.n_resources, events + [("add", merge),
                                                    ("delete", merge)]


def dataset(pkg: str, ds: str):
    """``(facts, program, n_resources)`` of a base dataset from ``pkg``."""
    data = __import__(f"{pkg}.data.datasets", fromlist=["pex"])
    gen = __import__(f"{pkg}.data.generator", fromlist=["generate"])
    if ds == "clique6":
        facts, prog, dic = data.single_clique(6)
    elif ds == "uobm_like":
        facts, prog, dic = gen.generate(**gen.PROFILES["uobm_like"])
    else:
        facts, prog, dic = getattr(data, ds)()
    return facts, prog, dic.n_resources


def _caps(eng) -> dict:
    return {a: getattr(eng, a) for a in CAP_ATTRS}


def _save(path: Path, **kw) -> None:
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **kw)
    os.replace(tmp, path)


# -- the reference side ----------------------------------------------------------

def start_reference(jobs: list[dict], out: Path, n_procs: int) -> list:
    """Start the reference on ``jobs`` in ``n_procs`` subprocesses (jobs
    dealt out in turn); returns the handles for :func:`wait_reference`."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           env.get("PYTHONPATH", "")]))
    procs = []
    for i in range(n_procs):
        part = jobs[i::n_procs]
        if not part:
            continue
        spec = out / f"jobs{i}.json"
        spec.write_text(json.dumps(part))
        log = open(out / f"ref{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(spec), str(out)],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log,
            out / f"ref{i}.log"))
    return procs


def wait_reference(procs: list, timeout_s: float = TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout_s
    for proc, log, path in procs:
        try:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            raise AssertionError(f"reference {path.name}: {rc}\n"
                                 + path.read_text()[-3000:])


def _ref_state(path: Path, eng, state, extra: dict) -> None:
    _save(path, **{k: np.asarray(getattr(state, k)) for k in ARRAYS},
          r=state.r, stats=json.dumps(state.stats.as_dict()),
          caps=json.dumps(_caps(eng)),
          explicit=np.asarray(state.explicit, np.int32).reshape(-1, 3),
          program=json.dumps([(r.head, r.body) for r in state.program.rules]),
          **extra)


def _ref_base(job: dict, out: Path) -> None:
    from repro.core.engine_jax import JaxEngine
    from repro.launch.mesh import make_engine_mesh, mesh_size

    facts, prog, n_res = dataset("repro", job["ds"])
    mesh = make_engine_mesh(job["D"])
    assert mesh_size(mesh) == job["D"]
    cap = job["cap"]
    eng = JaxEngine(n_res, capacity=cap, bind_cap=cap, out_cap=cap,
                    rewrite_cap=cap, mesh=mesh, route_cap=job["route_cap"],
                    fuse_rounds=job["fuse"])
    grows = []
    grow = eng._grow_for
    eng._grow_for = lambda kind: (grows.append(kind), grow(kind))[1]
    state = eng.materialise_state(facts, prog)
    _ref_state(out / f"{job['name']}.npz", eng, state, dict(
        facts=facts, grows=json.dumps(grows),
        triples=eng.state_triples(state)))


def _ref_route(job: dict, out: Path) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.engine_jax import _route_rows
    from repro.launch.mesh import make_engine_mesh

    for name, D, _n, rc, k in ROUTE_CASES:
        stream, flags, valid = route_inputs(name)
        mesh = make_engine_mesh(D)

        def body(s, f, v, D=D, rc=rc):
            so, fo, vo, ov = _route_rows(s, f, v, "data", D, rc)
            return so, fo, vo, ov[None]

        def body_noflags(s, v, D=D, rc=rc):
            so, _, vo, ov = _route_rows(s, None, v, "data", D, rc)
            return so, vo, ov[None]

        d = P("data")
        if flags is None:
            fn = jax.jit(shard_map(body_noflags, mesh=mesh, in_specs=(d, d),
                                   out_specs=(d, d, d)))
            so, vo, ov = fn(stream, valid)
            fo = np.zeros((np.asarray(so).shape[0], 0), np.int32)
        else:
            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(d, d, d),
                                   out_specs=(d, d, d, d)))
            so, fo, vo, ov = fn(stream, flags, valid)
        _save(out / f"route-{name}.npz", stream=np.asarray(so),
              flags=np.asarray(fo), valid=np.asarray(vo),
              overflow=np.asarray(ov))


def _ref_inc(job: dict, out: Path) -> None:
    from repro.core.engine_jax import JaxEngine
    from repro.core.materialise import materialise_rew
    from repro.core.triples import apply_op
    from repro.launch.mesh import make_engine_mesh

    facts, prog, n_res, events = inc_case("repro")
    eng = JaxEngine(n_res, capacity=1 << 10, bind_cap=1 << 10, out_cap=1 << 10,
                    rewrite_cap=1 << 10, mesh=make_engine_mesh(job["D"]),
                    route_cap=job["route_cap"], seed_chunk=128,
                    rederive_mode=job["rederive"], fuse_rounds=job["fuse"])
    state = eng.materialise_state(facts, prog)
    explicit = facts
    _ref_state(out / f"{job['name']}-e0.npz", eng, state, dict(
        triples=eng.state_triples(state), labels=json.dumps([])))
    for i, (op, delta) in enumerate(events, 1):
        explicit = apply_op(explicit, op, delta)
        labels = _ref_update(eng, state, op, delta)
        scratch = materialise_rew(explicit, prog, n_res)
        _ref_state(out / f"{job['name']}-e{i}.npz", eng, state, dict(
            triples=eng.state_triples(state), scratch=scratch.triples(),
            scratch_rep=scratch.rep, labels=json.dumps(labels)))


def _ref_update(eng, state, op: str, delta) -> list:
    """``JaxEngine._apply_update`` with the phase generator iterated here,
    so the last attempt's yield labels are kept."""
    from jax.experimental import enable_x64

    from repro.core import incremental_spmd as jinc
    from repro.core.engine_jax import CapacityError

    phases = jinc.spmd_add_phases if op == "add" else jinc.spmd_delete_phases
    eng._maybe_reset_fallback(state)
    while True:
        snap = eng._snapshot(state)
        try:
            eng._set_update_buffers(True)
            with enable_x64():
                labels = list(phases(eng, state, delta, 10_000))
            break
        except CapacityError as e:
            eng._recover_capacity(state, snap, e)
    eng._barrier(state)
    return labels


def reference_main(spec: str, out: str) -> None:
    import jax
    import jax.experimental
    import jax.extend.core

    # jax 0.9 moved these; the reference package imports them by their old
    # names
    jax.experimental.enable_x64 = jax.enable_x64
    jax.core.Jaxpr = jax.extend.core.Jaxpr
    assert len(jax.devices()) == 4, jax.devices()
    out = Path(out)
    for job in json.loads(Path(spec).read_text()):
        t0 = time.perf_counter()
        {"base": _ref_base, "route": _ref_route, "inc": _ref_inc}[job["kind"]](
            job, out)
        print(job.get("name", job["kind"]), f"{time.perf_counter() - t0:.1f}s",
              flush=True)


# -- the port side ---------------------------------------------------------------

def run_port(jobs: list[dict], out: Path, world: int = 4) -> None:
    """The port on ``jobs`` in ``world`` gloo processes (one thread each)."""
    from repro_torch.launch.mesh import spawn

    out.mkdir(parents=True, exist_ok=True)
    spec = out / "port_jobs.json"
    spec.write_text(json.dumps(jobs))
    spawn(port_main, world, (str(spec), str(out)),
          store_path=str(out / "store"), threads=1, timeout_s=300)


def _port_state(path: Path, eng, state, extra: dict) -> None:
    from repro_torch.core.engine import TorchEngine, state_to_arrays

    arrays = state_to_arrays(state)
    _save(path, **arrays, r=state.r, stats=json.dumps(state.stats.as_dict()),
          caps=json.dumps(_caps(eng)),
          explicit=TorchEngine.explicit_rows(state),
          program=json.dumps([(r.head, r.body) for r in state.program.rules]),
          **extra)


def _port_base(job: dict, mesh, out: Path) -> None:
    from repro_torch.core.engine import TorchEngine, index_invariant_report

    facts, prog, n_res = dataset("repro_torch", job["ds"])
    cap = job["cap"]
    eng = TorchEngine(n_res, device="cpu", capacity=cap, bind_cap=cap,
                      out_cap=cap, rewrite_cap=cap, mesh=mesh,
                      route_cap=job["route_cap"], fuse_rounds=job["fuse"])
    state = eng.materialise_state(facts, prog)
    triples = eng.state_triples(state)
    report = index_invariant_report(eng.gathered_state(state), eng.n_shards)
    _port_state(out / f"{job['name']}.r{mesh.rank}.npz", eng, state, dict(
        facts=facts, triples=triples, report=json.dumps(report),
        split=json.dumps({k: eng.last_split.get(k)
                          for k in ("graphs", "graphs_reason")}),
        dispatches=json.dumps(dict(eng.dispatches.by_family)),
        captures=eng.captures))


def _port_route(meshes: dict, out: Path) -> None:
    import torch

    from repro_torch.core.engine import _route_rows

    for name, D, n, rc, k in ROUTE_CASES:
        mesh = meshes[D]
        if mesh is None:
            continue
        stream, flags, valid = route_inputs(name)
        me = mesh.rank
        blk = slice(me * n, (me + 1) * n)
        so, fo, vo, ov = _route_rows(
            torch.from_numpy(stream[blk]),
            None if flags is None else torch.from_numpy(flags[blk]),
            torch.from_numpy(valid[blk]), mesh, rc)
        _save(out / f"route-{name}.r{me}.npz", stream=so.numpy(),
              flags=(np.zeros((so.shape[0], 0), np.int32) if fo is None
                     else fo.numpy()),
              valid=vo.numpy(), overflow=np.asarray([bool(ov)]))


def _port_inc(job: dict, mesh, out: Path) -> None:
    from repro_torch.core.engine import TorchEngine

    facts, prog, n_res, events = inc_case("repro_torch")
    eng = TorchEngine(n_res, device="cpu", capacity=1 << 10, bind_cap=1 << 10,
                      out_cap=1 << 10, rewrite_cap=1 << 10, mesh=mesh,
                      route_cap=job["route_cap"], seed_chunk=128,
                      rederive_mode=job["rederive"], fuse_rounds=job["fuse"])
    state = eng.materialise_state(facts, prog)
    base_retries = state.stats.capacity_retries
    _port_state(out / f"{job['name']}-e0.r{mesh.rank}.npz", eng, state, dict(
        triples=eng.state_triples(state), base_retries=base_retries,
        labels=json.dumps([])))
    for i, (op, delta) in enumerate(events, 1):
        (eng.add_facts if op == "add" else eng.delete_facts)(state, delta)
        _port_state(out / f"{job['name']}-e{i}.r{mesh.rank}.npz", eng, state,
                    dict(triples=eng.state_triples(state),
                         base_retries=base_retries,
                         labels=json.dumps([lb for lb, _ in
                                            eng.last_split["phases"]])))


def _port_coll(mesh, out: Path) -> None:
    """Each collective on known inputs: rank r's block holds r."""
    import torch

    from repro_torch.core import collectives as coll

    r, D = mesh.rank, mesh.world
    x = torch.arange(6, dtype=torch.int64).view(3, 2) + 100 * r
    blocks = torch.arange(D * 2, dtype=torch.int32).view(D, 2) + 10 * r
    flags = torch.tensor([r % 2 == 0, False, True])
    res = dict(
        gather=coll.all_gather(x, mesh).numpy(),
        gather_bool=coll.all_gather(flags, mesh).numpy(),
        a2a=coll.all_to_all(blocks, mesh).numpy(),
        psum=coll.psum(torch.tensor([r, 1], dtype=torch.int64), mesh).numpy(),
        psum_bool=coll.psum(flags, mesh).numpy(),
        pany=coll.pany(flags, mesh).numpy(),
        index=np.asarray([coll.axis_index(mesh)]),
        counts=json.dumps(mesh.counts()),
    )
    _save(out / f"coll-d{D}.r{r}.npz", **res)


def port_main(rank: int, world: int, spec: str, out: str) -> None:
    from repro_torch.launch.mesh import make_engine_mesh

    out = Path(out)
    # every rank builds every mesh, in the same order (new_group is
    # collective); a rank outside a mesh gets None and skips its jobs
    meshes = {n: make_engine_mesh(n) for n in (1, 2, 4) if n <= world}
    for job in json.loads(Path(spec).read_text()):
        if job["kind"] == "route":
            _port_route(meshes, out)
            continue
        if job["kind"] == "coll":
            for n, mesh in meshes.items():
                if mesh is not None:
                    _port_coll(mesh, out)
            continue
        mesh = meshes[job["D"]]
        if mesh is None:
            continue
        {"base": _port_base, "inc": _port_inc}[job["kind"]](job, mesh, out)


# -- comparisons -------------------------------------------------------------------

def load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def shard(ref: dict, name: str, D: int, s: int) -> np.ndarray:
    """Shard ``s``'s block of a reference state array (rho is shared)."""
    a = ref[name]
    if name == "rep":
        return a
    n = a.shape[0] // D
    return a[s * n:(s + 1) * n]


def assert_shard_equal(port: dict, ref: dict, D: int, s: int, tag: str) -> None:
    """A rank's eight arrays are the reference's shard ``s``."""
    for k in ARRAYS:
        want = shard(ref, k, D, s)
        np.testing.assert_array_equal(port[k].reshape(want.shape), want,
                                      err_msg=f"{tag} shard {s} {k}")


def assert_stats_equal(port: dict, ref: dict, tag: str) -> None:
    got, want = json.loads(str(port["stats"])), json.loads(str(ref["stats"]))
    for k, v in want.items():
        if k not in SKIP:
            assert got[k] == v, f"{tag} {k}: {got[k]} != {v}"


def packset(rows) -> set:
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    return set(((rows[:, 0] << 42) | (rows[:, 1] << 21) | rows[:, 2]).tolist())


if __name__ == "__main__":
    reference_main(sys.argv[1], sys.argv[2])
