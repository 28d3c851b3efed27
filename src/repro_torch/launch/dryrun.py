"""The dry run: one rank's step of every (architecture x shape x mesh) cell,
counted for the H100 without a card.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 256 or 512 fake XLA devices and reads the compiled module.  Here
one process joins a ``fake`` process group of the production mesh's size
(:func:`fake_group`: 256 ranks for (data 16, model 16), 512 for (pod 2,
data 16, model 16); the group moves nothing) as its rank 0, builds the
cell (:func:`repro_torch.launch.workloads.build_cell`) on
``make_production_mesh()``, and runs its step once on fake tensors of
that rank's blocks (``FakeTensorMode``, each input ``sharding.shard_shape``
of its global shape) under :class:`repro_torch.launch.costs.StepCounter`.
A decode cell's ``pos`` is a host int (the cache's last position), never a
value read back from the device.

Per cell the record (``build/dryrun/<arch>__<shape>__<mesh>.json``) holds
the reference's fields: ``status`` (``ok``, ``skipped`` or ``error``),
``n_devices``, the rank and its coordinates, times, ``cost`` (FLOPs by
kind, bytes, the hand-written kernels' share and launches),
``collectives`` (``by_kind``: calls and bytes each rank sends, keyed
``"<axes>:<op>"``, and each axis group's link), ``top_ops``, ``memory``
(the peak against the card's 80 GB), ``model_flops_global`` and
``notes``.  A host read inside a step (a value the fake tensors do not
have) is the cell's error: the dry run reports it and does not work round
it.  :mod:`repro_torch.launch.roofline` reads the records.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single [--jobs 4]

``--all`` runs each cell in a subprocess of its own with a time limit: a
crash or a blow-up stays in its cell, recorded as ``error`` with its last
lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.launch.costs import HW

ART_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")

TOP_OPS = 12


def cell_filename(arch: str, shape: str, mesh: str) -> str:
    return f"{arch.replace('/', '_')}__{shape}__{mesh}.json"


def list_cells(mesh_kinds) -> list:
    """All (arch, shape, mesh) cells in the reference's order (skips too)."""
    from repro_torch.configs import all_archs, get_arch

    return [(arch, shape.name, mk) for arch in all_archs()
            for shape in get_arch(arch).shapes for mk in mesh_kinds]


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as ``rank`` of a ``fake`` default process group of
    ``world`` ranks (collectives move nothing), destroyed after."""
    import torch.distributed as dist

    from repro_torch.compat import fake_store

    dist.init_process_group("fake", store=fake_store(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def links(mesh) -> dict:
    """Each axis group of ``mesh`` that holds this rank: its size, the
    nodes its ranks span (ranks row-major, ``cards_per_node`` a node) and
    the link rate a card gets in it (the slower one when it spans
    nodes)."""
    from repro_torch.launch.mesh import coords_of

    names = mesh.axis_names
    me = mesh.coords
    out = {}
    for k in range(1, 1 << len(names)):
        axes = tuple(a for i, a in enumerate(names) if k >> i & 1)
        ranks = [r for r in range(mesh.size)
                 if all(coords_of(mesh, r)[a] == me[a] for a in names if a not in axes)]
        if len(ranks) == 1:
            continue
        nodes = len({r // HW["cards_per_node"] for r in ranks})
        out["+".join(axes)] = dict(ranks=len(ranks), nodes=nodes, bytes_per_s=(
            HW["nvlink_bytes_per_s"] if nodes == 1 else HW["network_bytes_per_s"]))
    return out


def _fake_inputs(wl) -> list:
    """Each input as an empty tensor of this rank's block (fake under a
    ``FakeTensorMode``); a decode cell's ``pos`` the cache's last
    position, a host int."""
    import torch

    from repro_torch.compat import pytree
    from repro_torch.launch.sharding import shard_shape

    def block(sd, sh):
        return torch.empty(shard_shape(sd.shape, sh), dtype=sd.dtype)

    inputs = [pytree.tree_map(block, sd, sh)
              for sd, sh in zip(wl.input_specs, wl.in_shardings)]
    if wl.kind == "decode":
        inputs[-1] = wl.input_specs[1]["k"].shape[2] - 1
    return inputs


def counted_step(wl, mesh) -> tuple:
    """Run ``wl.step`` once on this rank's fake blocks under a
    :class:`~repro_torch.launch.costs.StepCounter` (and ``ops.traced``):
    ``(counter, donated storage pairs, FLOPs by FlopCounterMode, wall
    seconds)``; the mesh's counters hold the step's collectives."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.compat import pytree
    from repro_torch.kernels import ops
    from repro_torch.launch.costs import StepCounter

    def keys(tree):
        return [counter.key_of(t) for t in pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    counter = StepCounter()
    with FakeTensorMode(), ops.traced(counter):
        with FlopCounterMode(display=False) as flops, counter:
            inputs = _fake_inputs(wl)
            counter.mark("inputs")
            old = {i: keys(inputs[i]) for i in wl.donate}
            mesh.reset_counts()
            t0 = time.perf_counter()
            out = wl.step(*inputs)
            run_s = time.perf_counter() - t0
            donated = tuple((a, b) for i, ks in old.items()
                            for a, b in zip(ks, keys(out[i])) if a != b)
            del out, inputs  # their storages die inside the count
    return counter, donated, flops.get_total_flops(), run_s


def count_step(wl, mesh) -> dict:
    """Count one step of ``wl`` on this rank: the record's ``cost``,
    ``collectives``, ``top_ops``, ``memory`` and ``run_s``."""
    counter, donated, flops, run_s = counted_step(wl, mesh)
    mem = counter.memory(donated)
    mem.pop("peak_tensors")
    mem["fits_hbm"] = bool(mem["peak_bytes"] <= HW["hbm_bytes"])
    mem["hbm_bytes"] = HW["hbm_bytes"]
    by_kind = {k: dict(count=int(mesh.calls[k]), bytes=int(mesh.bytes[k]))
               for k in sorted(mesh.calls)}
    kernel = counter.kernel
    return dict(
        run_s=round(run_s, 2),
        cost=dict(flops_per_dev=float(flops + sum(v for k, v in kernel["ops"].items()
                                                  if k != "int")),
                  flops_by_kind={k: float(v) for k, v in sorted(counter.flops().items())},
                  bytes_per_dev=float(counter.bytes + kernel["bytes"]),
                  kernel_bytes_per_dev=float(kernel["bytes"]),
                  kernel_launches=dict(kernel["launches"])),
        collectives=dict(by_kind=by_kind, total_bytes=sum(v["bytes"] for v in by_kind.values()),
                         total_count=sum(v["count"] for v in by_kind.values()),
                         links=links(mesh)),
        top_ops=counter.ops.most_common(TOP_OPS),
        memory=mem)


def count_cell(spec, shape, mesh) -> dict:
    """Build the cell on ``mesh`` (a live mesh of the initialised group)
    and count one step of this rank: the record's fields but the cell's
    names."""
    from repro_torch.launch.workloads import build_cell

    t0 = time.perf_counter()
    wl = build_cell(spec, shape, mesh)
    rec = dict(n_devices=mesh.size, rank=mesh.rank, coords=mesh.coords,
               mesh_shape=dict(mesh.shape), build_s=round(time.perf_counter() - t0, 2))
    rec.update(count_step(wl, mesh))
    rec.update(model_flops_global=wl.model_flops, notes=wl.notes)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             reduced: bool = False) -> dict:
    """Count one cell in this process as rank 0 of the production mesh
    and write its record (``reduced``: the arch's reduced config at the
    shape's sizes, the tests' quick check of the machinery)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh

    spec = get_arch(arch)
    if reduced:
        spec = dataclasses.replace(spec, config=spec.reduced)
    shape = spec.shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
           "config": spec.config.name, "status": "ok"}
    if shape.skip:
        rec.update(status="skipped", skip_reason=shape.skip)
        _write(rec, out_dir)
        print(f"[dryrun] SKIP {arch}:{shape_name}:{mesh_kind} - {shape.skip}")
        return rec
    multi = mesh_kind == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        rec.update(count_cell(spec, shape, mesh))
    _write(rec, out_dir)
    mem, cost = rec["memory"], rec["cost"]
    print(f"[dryrun] OK {arch}:{shape_name}:{mesh_kind} devs={rec['n_devices']} "
          f"run={rec['run_s']}s flops/dev={cost['flops_per_dev']:.3e} "
          f"bytes/dev={cost['bytes_per_dev']:.3e} "
          f"coll_bytes/dev={rec['collectives']['total_bytes']:.3e} "
          f"peak_mem={mem['peak_bytes'] / 1e9:.2f}GB fits={mem['fits_hbm']}")
    return rec


def _write(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_filename(rec["arch"], rec["shape"], rec["mesh"]))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def _error(arch: str, shape: str, mesh: str, tail: list) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
            "error_tail": tail}


def _run_one(cell, out_dir: str, timeout_s: float) -> tuple:
    arch, shape, mk = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mk, "--out", out_dir]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, timeout=timeout_s, capture_output=True, text=True)
        ok = proc.returncode == 0
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
    except subprocess.TimeoutExpired:
        ok, tail = False, ["TIMEOUT"]
    path = os.path.join(out_dir, cell_filename(arch, shape, mk))
    if ok:
        with open(path) as f:
            rec = json.load(f)
        print(f"[dryrun] done {arch}:{shape}:{mk} -> {rec['status']} ({time.time() - t0:.0f}s)",
              flush=True)
    else:
        rec = _error(arch, shape, mk, tail)
        _write(rec, out_dir)
        print(f"[dryrun] ERROR {arch}:{shape}:{mk} ({time.time() - t0:.0f}s)", flush=True)
        for line in tail:
            print("    " + line, flush=True)
    return arch, shape, mk, rec["status"]


def run_all(mesh_kinds, out_dir: str, timeout_s: float = 3600, only_missing: bool = False,
            pattern: str | None = None, jobs: int = 1) -> int:
    cells = list_cells(mesh_kinds)
    if pattern:
        cells = [c for c in cells if pattern in ":".join(c)]
    results, todo = [], []
    for cell in cells:
        path = os.path.join(out_dir, cell_filename(*cell))
        if only_missing and os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                results.append((*cell, prev["status"]))
                continue
        todo.append(cell)
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        results += list(pool.map(lambda c: _run_one(c, out_dir, timeout_s), todo))
    n_ok = sum(1 for r in results if r[3] == "ok")
    n_skip = sum(1 for r in results if r[3] == "skipped")
    print(f"[dryrun] SUMMARY: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} error")
    return 1 if len(results) - n_ok - n_skip else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--pattern", help="substring filter on arch:shape:mesh")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1, help="cells counted at once (--all)")
    args = ap.parse_args()

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return run_all(mesh_kinds, args.out, args.timeout, args.only_missing, args.pattern,
                       args.jobs)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    code = 0
    for mk in mesh_kinds:
        try:
            run_cell(args.arch, args.shape, mk, args.out)
        except Exception:
            traceback.print_exc()
            _write(_error(args.arch, args.shape, mk,
                          traceback.format_exc().splitlines()[-8:]), args.out)
            code = 1
    return code


if __name__ == "__main__":
    sys.exit(main())
