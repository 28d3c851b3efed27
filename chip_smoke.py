"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --rew-kernels [--src DIR]

The second form times only the REW path's rewrite and ``merge_pairs`` of
the port under ``DIR`` (default: this checkout's ``src``), through entry
points that every tree of the port has, and prints one JSON line: copy the
script into another tree (the parent, unpacked by ``git archive`` under
``build/``) and run both trees in turns, A B B A, to compare them on one
card; each tree builds its own kernels.  Its ``digest`` must be the same
for every tree.  The first form runs these phases, each of which raises
on failure (the script then exits non-zero and prints no result):

1. the card: ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build: every hand-written kernel from ``src/repro_torch/kernels/csrc``
   into ``build/kernels/``, one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes its path gives it; exact equality for the integer
   kernels, stated tolerances for flash attention, the FM interaction, the
   segment sum (on the OpenCyc-scale KG's real in-edges, its hub included;
   also bit equality from run to run) and the embedding bag; the sort also
   on signed keys and on the GNN plan's destination ids.  Flash (bf16)
   also within one output rounding of its plain version, and with P.V at
   more than bf16 precision: fewer of its outputs round otherwise than
   bf16 of the f32 result than halfway between P split into two bf16
   halves and P in bf16.  The search in each form (one side, both
   sides, sorted and random queries, the prefix form on random and sorted
   rows) bit-equal to its plain version.  The union-find's union, and
   ``merge_pairs`` as a whole, held against their plain versions after the
   compression, and two card runs bit-equal.  Times from CUDA events (median
   of single calls) for the kernel, its plain version and the PyTorch
   calls that compute the same function as a yardstick, beside the least
   time the card could take; for flash, SDPA, the segment sum,
   ``index_add_``, the rewrite, ``rho[spo]``, the union, the compression
   and ``merge_pairs`` also the device time a call under torch.profiler; for
   the embedding bag also a plain gather of the same rows.  The bag's main
   row takes the FM path's ids, banded by field; ids drawn over the whole
   table, and ids into one field's rows, are other rows;
4. mid-size: the ``opencyc_like``, ``merge_like``, ``chain_like`` and
   ``claros_like`` profiles through the default engine (the fused loop,
   one CUDA graph replay a round) on the card equal the host loop
   (``fuse_rounds=False``) on the card and both loops on the CPU
   (triples, rho, counters), and Theorem 1 holds on the card's result
   against the port's host AX materialisation (``check_theorem1``);
5. REW at full size: ``opencyc_like`` at OpenCyc's scale (2.4 M explicit
   triples, 361,200 merged resources) materialised on the card through
   :class:`repro_torch.TorchEngine`: three runs of the host loop, then the
   default engine's first run (round 1 eager, the capture of the round
   graph, one replay and one host read a round; its wall time is the
   end-to-end number and its launches the main path's) and three reruns
   that replay the graph from round 1; each run's wall split (set-up, each
   round's wall, wait and reads, stats) and peak memory (allocated and
   reserved, the graph's pool included).  Structural checks of the result;
   one union and one compression launched per round (the engine merges
   once a round); the host loop, the numpy host REW (timed once) and the
   same run on the CPU under both loops (the kernels' plain versions) give
   the same triples, rho and counters.  At the end, profiled reruns of both loops
   for the device's busy time, and the host loop's search calls counted
   by form, order and size with each one's device time;
5b. incremental maintenance: at mid size, phase 4's profiles each take an
   update stream (``sample_update_stream``, 6 events of 24 rows) under both
   loops on the card and the CPU, equal after every event (arrays,
   explicit set, program, counters), and the card's state equal to a
   from-scratch card run of the updated explicit set and to the numpy host
   subsystem (rho and the normal-form set).  At full size, phase 5's facts
   take 8 change sets of 4,096 rows (half deletes; 40 % of an add's rows
   fresh ``:idProp`` pairs that merge two cliques) on the default engine
   from its fused base state: each event's wall, its split at the phase
   generator's yields, waves, rounds, overdeleted rows, splits, rederived
   and re-merged rules, retries, captures, launches by kernel and peak
   memory, and its state equal to a from-scratch fused card run (whose
   wall is printed beside); the numpy host subsystem timed on the first
   add and the first delete (stopped after an event of more than 60 s).
   At the end, one add and one delete profiled;
5c. the serving tier: at mid size, phase 4's profiles each take a mixed
   trace (``sample_update_stream`` with ``p_query=0.5``, four point
   lookups after each event) through a ``TripleStore`` on the card and one
   on the CPU under one tick pattern (the same answers and epochs, every
   published snapshot bit for bit), then through a threaded store on the
   card (each answer and snapshot equal to the CPU's at its epoch). At full
   size, a store on phase 5's facts (caps 2^22): 4,096 point lookups
   drained in shape groups and in bursts of 256 (a seeded sample of 512
   against the host scalar path, timed; of 512 queries of the generator's
   mix, those no wider than the matcher's width against it too), phase
   5b's 8 change sets through the cooperative scheduler with a burst of
   256 lookups after each phase step, each answer held against the scalar
   path at its epoch, the final snapshot against a from-scratch card run,
   then the same stream on a threaded store while this thread reads;
   publication times and their split, per-query latency idle and busy,
   launches by phase, peak memory, and at the end a profiled drain;
6. LM serving at full width: SmolLM-135M (random weights from seed 0) with
   the flash kernel behind ``ServeEngine`` (16 slots, 1024 rows) answers 64
   requests of 32-512 prompt tokens and 32 new tokens; wall, tokens per
   second, peak memory; the card's teacher-forced logits of two requests
   equal the CPU's within a stated tolerance; at the end a profiled rerun
   for the device's and the flash kernel's share;
7. FM serving at full scale: the Criteo-scale FM (33,763,328 table rows,
   seeded non-zero first-order weights) with the FM kernel and the
   embedding bag serves a batch of 512 and one of 262,144 through a rho
   made by the port's union-find from seeded merge pairs, and scores one
   user against 1,000,000 candidates; merged IDs score the same, and the
   card equals the CPU at batch 512 and on the candidates; at the end a
   profiled rerun of the bulk batch for the device's busy share and each
   kernel's time;
8. GNN inference on the sameAs-deduplicated KG: GatedGCN and PNA at full
   width against the CPU on ``full_graph_sm`` (2,708 nodes, 10,556
   edges); the mid-size ``opencyc_like`` KG's graph deduplicated on the
   card equals the CPU's exactly and GatedGCN on it agrees with the CPU;
   then at full size, from phase 5's facts and rho, the raw graph (2.4 M
   edges) and the deduplicated one: the dedup's time, GatedGCN at full
   width (16 layers) on both (wall, edges/s, peak memory, in-degree),
   a profiled rerun for the segment sum's share and the segment plan's
   sort and search, PNA on the deduplicated graph; 32 segment-sum launches
   a GatedGCN forward, and two card runs bit-equal.

Each path's launch counters are set to 0 just before its run and read just
after.  Every wall and every CUDA-event time is taken before the process's
first torch.profiler session: a finished profiler session leaves host cost
on every later launch, which the host-bound REW and LM walls would carry.
So phase 8 profiles its forward after its own walls, the profiled reruns
of phases 5, 5b and 6, the search census and the kernels' device times run
after phase 8 with phase 7's, and phase 6 then times its traffic once more
to show that cost.  A profiler session whose kept run holds no device
event is made again, up to three in all; a kernel's device time a call
then falls back to CUDA events, and the record counts both.
Then one JSON line ``{"kernels": [...]}`` and, last, the device line.  The
full record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12   # H100 SXM non-tensor FP32 rate, the ALU stand-in
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
KEY_MAX = (1 << 63) - 1
FULL = dict(n_groups=51600, n_plain=1470000)  # OpenCyc: 2.4 M triples
FULL_MERGED = 7 * 51600  # group_size 8: seven merges per group
FULL_RESOURCES = 971865  # resources of that profile at that scale
FULL_CAP = 1 << 22
FULL_EDGES = 2398800  # explicit triples of that profile: the KG graph's edges
REW_KERNELS = ("dedup_order", "search_bounds", "rewrite_triples", "uf_compress",
               "uf_union")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, setup=lambda: (), reps: int = 5) -> float:
    """Median of single-call CUDA-event times, after one warm-up call;
    ``setup`` makes fresh arguments outside the timed region."""
    times = []
    for i in range(reps + 1):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log2c(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def packed_keys(gen, n: int, n_ids: int, dev) -> torch.Tensor:
    spo = torch.randint(0, n_ids, (n, 3), generator=gen, device=dev)
    return (spo[:, 0] << 42) | (spo[:, 1] << 21) | spo[:, 2]


def recorder(records: dict):
    """``record(...)``: print one kernel measurement, fail if the kernel
    and its plain version differ by more than ``tol``, and keep it."""
    def record(name, shape, err, ms, plain_ms, lib_ms, n_bytes, n_ops,
               main=False, tol=0.0, ops_per_s=SCALAR_OPS_PER_S, extra=None):
        b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {name} {shape}{' [main path]' if main else ''}: max_abs_err "
              f"{err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib}, bound {b_ms:.4f} ms ({b_by})"
              f"{'' if extra is None else ' ' + json.dumps(extra)}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {shape} differs from its plain version "
                                 f"by {err} > {tol}")
        records.setdefault(name, []).append(dict(
            shape=shape, main_path=main, max_abs_err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            **(extra or {}),
        ))
    return record


def kernel_phase(ops, ref, records: dict, dev) -> None:
    """The REW kernels against their plain versions, here and in the two
    functions below, at the shapes the full-size main path gives them
    (``main=True``: the stream of 4 * (out_cap + rewrite_cap) + 1 = 2^25 + 1
    keys, the arena of 2^22 + 1 rows, rho of 971,865 resources, a pair
    buffer of out_cap rows); the sort also on 2^24 + 1 keys over the whole
    signed range."""
    gen = torch.Generator(device=dev).manual_seed(0)
    record = recorder(records)

    # stable dedup order: packed keys, duplicates, KEY_MAX tail
    stream = 4 * (FULL_CAP + FULL_CAP) + 1
    for n, label in ((1 << 20, "2^20"), (1 << 24, "2^24"),
                     (stream, "2^25+1")):
        keys = packed_keys(gen, n, 1 << 8, dev)  # small IDs: many duplicates
        keys[-(n // 8):] = KEY_MAX
        keys = keys[torch.randperm(n, generator=gen, device=dev)].contiguous()
        err = max_err(ops.dedup_order(keys), ref.dedup_order(keys))
        record("dedup_order", f"n={label}", err,
               time_ms(lambda: ops.dedup_order(keys)),
               time_ms(lambda: ref.dedup_order(keys)),
               time_ms(lambda: torch.sort(keys, stable=True)),
               12 * n, n * log2c(n), main=n == stream)
    # the whole signed range, LLONG_MIN and -1 among them
    n = (1 << 24) + 1
    keys = (torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, device=dev) << 32
            | torch.randint(0, 1 << 32, (n,), generator=gen, device=dev))
    keys[torch.randint(0, n, (n // 64,), generator=gen, device=dev)] = -(1 << 63)
    keys[torch.randint(0, n, (n // 64,), generator=gen, device=dev)] = -1
    record("dedup_order", "n=2^24+1 signed", max_err(ops.dedup_order(keys),
                                                      ref.dedup_order(keys)),
           time_ms(lambda: ops.dedup_order(keys)),
           time_ms(lambda: ref.dedup_order(keys)),
           time_ms(lambda: torch.sort(keys, stable=True)),
           12 * n, n * log2c(n))



def search_kernel_phase(ops, ref, records: dict, dev) -> None:
    """The sorted-key search at the full-size REW path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    record = recorder(records)
    stream = 4 * (FULL_CAP + FULL_CAP) + 1
    # sorted-key search into the arena index (2^22+1 keys, a KEY_MAX
    # tail of v/8), each form against the PyTorch calls that compute the
    # same function: the membership probe (the main path: the sorted
    # stream, one side) against one torch.searchsorted; both sides, sorted
    # and at 2^22 random queries, against two (left and right); the prefix
    # form against two on the packed low and high keys, as its plain
    # version does (the packing is left out of the library's time).  The
    # bytes: each query (8) and key (8) read once, 4 a side a query written.
    v = FULL_CAP + 1
    keys = torch.sort(packed_keys(gen, v, 1 << 20, dev)).values
    keys[-(v // 8):] = KEY_MAX

    def search_queries(n):
        hits = keys[torch.randint(0, v, (n // 2,), generator=gen, device=dev)]
        return torch.cat([hits, packed_keys(gen, n - n // 2, 1 << 20, dev)])

    def both_sides(queries):
        return (torch.searchsorted(keys, queries),
                torch.searchsorted(keys, queries, side="right"))

    queries = torch.sort(search_queries(stream)).values
    n = queries.shape[0]
    want = ref.search_bounds(queries, keys)
    err = max(max_err(ops.searchsorted(keys, queries), want[0]),
              max_err(ops.searchsorted(keys, queries, side="right"), want[1]))
    record("search_bounds", "one side (left), n=2^25+1 sorted, v=2^22+1", err,
           time_ms(lambda: ops.searchsorted(keys, queries)),
           time_ms(lambda: ref.search_bounds(queries, keys)),
           time_ms(lambda: torch.searchsorted(keys, queries)),
           8 * n + 8 * v + 4 * n, n * log2c(v + 1), main=True)
    for label, q in (("both sides, n=2^25+1 sorted, v=2^22+1", queries),
                     ("both sides, n=2^22 random, v=2^22+1", search_queries(1 << 22))):
        n = q.shape[0]
        record("search_bounds", label,
               max_err(ops.search_bounds(q, keys), ref.search_bounds(q, keys)),
               time_ms(lambda: ops.search_bounds(q, keys)),
               time_ms(lambda: ref.search_bounds(q, keys)),
               time_ms(lambda: both_sides(q)),
               8 * n + 8 * v + 8 * n, 2 * n * log2c(v + 1))
    del queries, want
    n = 1 << 22
    rows = torch.stack([keys[:v] >> 42, (keys[:v] >> 21) & ((1 << 21) - 1)], dim=1)
    prefix = rows[torch.randint(0, v, (n,), generator=gen, device=dev)]
    for order, prefix in (("random", prefix.to(torch.int32).contiguous()),
                          ("sorted", rows[:n].to(torch.int32).contiguous())):
        lo = (prefix[:, 0].long() << 42) | (prefix[:, 1].long() << 21)
        hi = lo | ((1 << 21) - 1)
        record("search_bounds", f"prefix form, n=2^22 {order} rows, k=2, v=2^22+1",
               max_err(ops.prefix_range_bounds(prefix, keys),
                       ref.prefix_range_bounds(prefix, keys)),
               time_ms(lambda: ops.prefix_range_bounds(prefix, keys)),
               time_ms(lambda: ref.prefix_range_bounds(prefix, keys)),
               time_ms(lambda: (torch.searchsorted(keys, lo),
                                torch.searchsorted(keys, hi, side="right"))),
               8 * n + 8 * v + 8 * n, 2 * n * log2c(v + 1))
    del rows, prefix, keys


def plain_merge(ref, rep, pairs, valid):
    """``merge_pairs`` through the plain versions: clone, union, compress."""
    out = rep.clone()
    ref.uf_union_(out, pairs, valid)
    ref.uf_compress_(out)
    return out


def rewrite_inputs(n: int, form: str, seed: int, dev):
    """(spo, rho, masks) of one rewrite form: n random rows under a rho of
    971,865 resources merged in 8-cliques (each maps to its minimum); the
    candidates' ``valid`` (90 %) or the sweep's ``epoch``/``marked``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    V = FULL_RESOURCES
    rho = torch.arange(V, dtype=torch.int32, device=dev) // 8 * 8
    spo = torch.randint(0, V, (n, 3), generator=gen, device=dev, dtype=torch.int32)
    if form == "normalise":
        return spo, rho, {"valid": torch.rand(n, generator=gen, device=dev) < 0.9}
    epoch = torch.randint(-1, 8, (n,), generator=gen, device=dev, dtype=torch.int32)
    return spo, rho, {"epoch": epoch,
                      "marked": torch.rand(n, generator=gen, device=dev) < 0.1}


def union_inputs(main: bool, seed: int, dev):
    """(V, the pairs in order (k, 2), the (m, 2) int32 pair buffer, its
    flags).  Main path: 51,600 8-cliques given as all 64 ordered pairs each
    (the idProp rule's output) in a buffer of out_cap rows, over 971,865
    resources.  Stress: 2^20 resources whose 8-cliques are hooked pairwise
    (x, x+1), plus one 2^16-long chain; the buffer holds just the pairs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if main:
        V, width = FULL_RESOURCES, FULL_CAP
        g = torch.arange(FULL["n_groups"], device=dev) * 8
        i, j = torch.meshgrid(torch.arange(8, device=dev), torch.arange(8, device=dev),
                              indexing="ij")
        pairs = torch.stack([(g[:, None, None] + i).reshape(-1),
                             (g[:, None, None] + j).reshape(-1)], dim=1)
    else:
        V, width = 1 << 20, None
        x = torch.arange(V - 1, device=dev)
        chain = (x % 8 != 7) | ((x >= 1 << 18) & (x < (1 << 18) + (1 << 16)))
        pairs = torch.stack([x, x + 1], dim=1)[chain]
    pairs = pairs[torch.randperm(pairs.shape[0], generator=gen, device=dev)]
    k = pairs.shape[0]
    m = width or k
    buf = torch.zeros((m, 2), dtype=torch.int32, device=dev)
    buf[:k] = pairs.flip(1)
    return V, pairs, buf, torch.arange(m, device=dev) < k


def kernel_device_ms(fn, name: str, calls: int = 20) -> float | None:
    """Device time a call of the port kernel ``name`` among ``fn``'s
    kernels (torch.profiler, the mean of ``calls`` calls); None where the
    trace holds none of it."""
    def run():
        for _ in range(calls):
            fn()

    prof, _, _ = profiled(run)
    ms = device_time(prof, 1.0)["port_kernels_ms"].get(name)
    return None if ms is None else ms / calls


def rew_kernel_phase(ops, ref, records: dict, dev, later: list) -> None:
    """Rewrite and union-find at the full-size REW path's shapes; each
    kernel's device time a call (torch.profiler, on inputs made anew from
    the same seeds) goes to ``later``."""
    from repro_torch.core.uf import merge_pairs, merge_pairs_np

    record = recorder(records)
    # rewrite.  Bytes: spo read and out written (12 a row each), the masks
    # (1 or 5 a row), the flags (1) and rho once; the lookups move a
    # 32-byte sector each from L2 (kept beside the bound: it may set the
    # floor above it)
    V = FULL_RESOURCES
    for n, form, seed in ((1 << 22, "normalise", 4), (FULL_CAP + 1, "sweep", 5)):
        spo, rho, kw = rewrite_inputs(n, form, seed, dev)
        err = max(max_err(ops.rewrite_triples(spo, rho), ref.rewrite_triples(spo, rho)),
                  max_err(ops.rewrite_triples(spo, rho, **kw),
                          ref.rewrite_triples(spo, rho, **kw)))
        mask_bytes = n if form == "normalise" else 5 * n
        lookups = 3 * (int(kw["valid"].sum()) if form == "normalise" else n)
        record("rewrite_triples", f"{form} n={n},V={V}", err,
               time_ms(lambda: ops.rewrite_triples(spo, rho, **kw)),
               time_ms(lambda: ref.rewrite_triples(spo, rho, **kw)),
               time_ms(lambda: rho[spo.to(torch.int64)]),
               12 * n + 4 * V + mask_bytes + 12 * n + n, 4 * n,
               main=form == "sweep",
               extra=dict(lookup_sector_bytes=lookups * SECTOR))

        def rewrite_device(entry=records["rewrite_triples"][-1], n=n, form=form,
                           seed=seed):
            spo, rho, kw = rewrite_inputs(n, form, seed, dev)
            entry.update(
                device_ms=kernel_device_ms(lambda: ops.rewrite_triples(spo, rho, **kw),
                                           "rewrite_triples"),
                library_device_ms=device_ms_per_call(lambda: rho[spo.to(torch.int64)],
                                                     calls=20))
            print(f"  rewrite_triples {entry['shape']}: device ms a call "
                  f"(torch.profiler) kernel {entry['device_ms']}, rho[spo] "
                  f"{entry['library_device_ms']:.4f}", flush=True)

        later.append(rewrite_device)
    del spo, rho, kw

    # union-find: the union on the card, compressed, against the plain
    # version, merge_pairs and merge_pairs_np; two card runs bit-equal
    for main, seed, label in ((True, 6, "main: 51,600 8-cliques, all pairs"),
                              (False, 7, "stress: 8-cliques pairwise + a 2^16 chain")):
        V, pairs, buf, pv = union_inputs(main, seed, dev)
        k, m = pairs.shape[0], buf.shape[0]
        base = torch.arange(V, dtype=torch.int32, device=dev)
        runs = []
        for _ in range(2):
            got = base.clone()
            ops.uf_union_(got, buf, pv)
            ops.uf_compress_(got)
            runs.append(got)
        want_np, _ = merge_pairs_np(np.arange(V, dtype=np.int32), pairs.cpu().numpy())
        plain = plain_merge(ref, base, buf, pv)
        merged = merge_pairs(base, buf, pv)
        if max_err(runs[0], runs[1]) or not np.array_equal(merged.cpu().numpy(), want_np):
            raise AssertionError(f"union ({label}) differs between card runs or "
                                 "from merge_pairs_np")
        n_hooked = int((plain != base).sum())  # the roots the union writes
        n_ends = int(torch.unique(pairs).numel())  # the rep entries it reads
        # union: reads every flag (1 a row), the pair of each valid row (8)
        # and rep at each endpoint (4) once, writes the roots it hooks; a
        # masked row's pair is never read.  Held against the plain version
        # after compress
        record("uf_union", f"{label}, V={V}, m={m}",
               max(max_err(runs[0], plain), max_err(merged, plain)),
               time_ms(ops.uf_union_, lambda: (base.clone(), buf, pv)),
               time_ms(ref.uf_union_, lambda: (base.clone(), buf, pv)),
               None, m + 8 * k + 4 * n_ends + 4 * n_hooked, 2 * k, main=main)
        # compress: the forest one scatter-min of the pairs leaves
        lo, hi = pairs.min(dim=1).values, pairs.max(dim=1).values
        hooked = base.clone().scatter_reduce_(0, hi, lo.to(torch.int32), "amin")
        c_kernel, c_plain = hooked.clone(), hooked.clone()
        ops.uf_compress_(c_kernel)
        ref.uf_compress_(c_plain)
        n_moved = int((c_plain != hooked).sum())  # the entries compress writes
        # compress reads rep once and writes the entries that move
        record("uf_compress", f"{label}, V={V}", max_err(c_kernel, c_plain),
               time_ms(ops.uf_compress_, lambda: (hooked.clone(),)),
               time_ms(ref.uf_compress_, lambda: (hooked.clone(),)),
               None, 4 * V + 4 * n_moved, V, main=main)
        # the whole merge: reads rep, the flags and the valid rows' pairs,
        # writes the new rep
        record("merge_pairs", f"{label}, V={V}, m={m}", max_err(merged, plain),
               time_ms(lambda: merge_pairs(base, buf, pv)),
               time_ms(lambda: plain_merge(ref, base, buf, pv)),
               None, m + 8 * k + 8 * V, 2 * k, main=main)

        def union_device(entries=(records["uf_union"][-1], records["uf_compress"][-1],
                                  records["merge_pairs"][-1]), main=main, seed=seed):
            V, pairs, buf, pv = union_inputs(main, seed, dev)
            base = torch.arange(V, dtype=torch.int32, device=dev)
            lo, hi = pairs.min(dim=1).values, pairs.max(dim=1).values
            hooked = base.clone().scatter_reduce_(0, hi, lo.to(torch.int32), "amin")
            union, compress, merge = entries
            union["device_ms"] = kernel_device_ms(
                lambda: ops.uf_union_(base.clone(), buf, pv), "uf_union")
            compress["device_ms"] = kernel_device_ms(
                lambda: ops.uf_compress_(hooked.clone()), "uf_compress")
            merge["device_ms"] = device_ms_per_call(lambda: merge_pairs(base, buf, pv),
                                                    calls=20)
            print(f"  union-find {union['shape']}: device ms a call (torch.profiler) "
                  f"uf_union {union['device_ms']}, uf_compress {compress['device_ms']}, "
                  f"merge_pairs {merge['device_ms']:.4f}", flush=True)

        later.append(union_device)


def float_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape} {a.dtype} != {b.shape} {b.dtype}")
    return float((a.float() - b.float()).abs().max())


FLASH_TOL = 2e-2   # bf16 outputs of magnitude < 4: one rounding apart at most
FLASH_RTOL = 2.0**-7  # and each value within one bf16 rounding of itself
FLASH_ATOL = 1e-4     # plus this: well under the spread of a row at 32k keys
FLASH_REPS = 50       # single calls in a flash time's median: a short call
                      # is mostly host work, and the host's times spread


def flash_scaled_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| - FLASH_RTOL |want|: at most FLASH_ATOL."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - FLASH_RTOL * w.abs()).max())


def p_rounding_shares(q, k, v, q_offset: int, got: torch.Tensor) -> dict:
    """Causal attention in f32 by blocks of query rows, three ways: P.V from
    P in f32, from bf16(P) plus bf16(P - bf16(P)) (the kernel's split) and
    from bf16(P) alone.  Returns the share of bf16 outputs that round
    otherwise than bf16 of the f32 result, for ``got`` and both schemes."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(t, device=q.device)
    differ = dict(kernel=0, split=0, bf16=0)
    step = max(1, (1 << 26) // (b * h * t))
    for s0 in range(0, s, step):
        qf = q[:, s0:s0 + step].float()
        n = qf.shape[1]
        scores = torch.einsum("bskgd,btkd->bkgst", qf.reshape(b, n, kv, h // kv, d),
                              kf) / d**0.5
        q_pos = q_offset + s0 + torch.arange(n, device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, -1e30)
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30).permute(0, 3, 1, 2, 4)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()

        def out(pv):
            o = torch.einsum("bkgst,btkd->bskgd", pv, vf) / l
            return o.reshape(b, n, h, d).to(torch.bfloat16)

        want = out(p)
        differ["kernel"] += int((got[:, s0:s0 + n] != want).sum())
        differ["split"] += int((out(hi + lo) != want).sum())
        differ["bf16"] += int((out(hi) != want).sum())
    return {key: n / got.numel() for key, n in differ.items()}


PROFILE_SESSIONS = 3  # torch.profiler sessions tried before a trace counts as lost
PROFILER_LOST = dict(sessions=0, event_timed=0)  # goes to the record


def lost_session(session: int) -> None:
    """Note a session whose kept run holds no device event and, unless it
    was the last one tried, wait a second before the next: CUPTI has
    dropped every kernel of a session begun just after another one."""
    PROFILER_LOST["sessions"] += 1
    print(f"  torch.profiler kept no device event (session {session} of "
          f"{PROFILE_SESSIONS})", flush=True)
    if session < PROFILE_SESSIONS:
        time.sleep(1.0)


def profiled(fn):
    """``fn()`` twice under torch.profiler, keeping the second run's trace:
    CUPTI can miss the first kernels launched after tracing starts (a
    profiled GNN forward has lost its first two, the segment plan's sort
    and search), so the first run is the profiler's warm-up step.  A
    session whose kept run holds no device event is made again, up to
    ``PROFILE_SESSIONS`` in all.  Returns the profile, the kept run's host
    wall (it ends in a synchronise) and its result."""
    for session in range(1, PROFILE_SESSIONS + 1):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            for _ in range(2):
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.step()
        if device_time(prof, wall)["busy_ms"] > 0:
            break
        lost_session(session)
    return prof, wall, out


def device_ms_per_call(fn, calls: int = 50) -> float:
    """Device time of one call of ``fn``: all its kernels, under
    torch.profiler, averaged over ``calls`` calls after a warm-up step of
    as many.  Where every session loses its trace, the CUDA-event time of
    the ``calls`` calls (host gaps between kernels included) over
    ``calls``, counted in ``PROFILER_LOST``."""
    def run():
        for _ in range(calls):
            fn()

    prof, _, _ = profiled(run)
    busy = device_time(prof, 1.0)["busy_ms"]
    if busy > 0:
        return busy / calls
    PROFILER_LOST["event_timed"] += 1
    print(f"  CUDA-event time of {calls} calls instead", flush=True)
    return time_ms(run, reps=1) / calls


FM_TOL_REL = 1e-5  # f32 sums in another order


def flash_calls(ops, q, k, v, off: int):
    """The flash kernel on (q, k, v) at ``off`` and SDPA on the same
    attention: causal at offset 0; for a decode row (S 1), on the keys
    up to q_offset, unmasked (SDPA's causal mask is aligned top-left)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if off:
        assert q.shape[1] == 1
        kt, vt = kt[:, :, :off + 1], vt[:, :, :off + 1]

    def flash():
        return ops.flash_attention(q, k, v, q_offset=off)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=not off,
                                              enable_gqa=True)
    return flash, library


def serving_kernel_phase(ops, ref, records: dict, dev, later: list) -> None:
    """Flash attention at SmolLM-135M's heads (9 over 3 KV heads, D 64,
    bf16): the server's prefill of 512 tokens (the main path's shape: the
    server prefills each request alone), a prefill of 32,768 tokens
    (``prefill_32k``'s length) and a decode step of 16 rows against a
    1,024-row cache at q_offset 700; the FM interaction at the FM's
    ``serve_p99`` and ``serve_bulk`` batches (39 fields, K 10, f32).
    SDPA is flash's yardstick: causal at offset 0, and for the decode
    step on the keys up to q_offset, unmasked.  The device times under
    torch.profiler go to ``later``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION]

    record = recorder(records)
    gen = torch.Generator(device=dev).manual_seed(1)
    h, kv, d = 9, 3, 64
    for b, s, t, off, label, main in (
        (1, 512, 512, 0, "prefill (1, 512, 9/3, 64)", True),
        (1, 32768, 32768, 0, "prefill (1, 32768, 9/3, 64)", False),
        (16, 1, 1024, 700, "decode (16, 1, T 1024, 9/3, 64) at q_offset 700", False),
    ):
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, t, kv, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, t, kv, d, generator=gen, device=dev).to(torch.bfloat16)
        got = ops.flash_attention(q, k, v, q_offset=off)
        want = ref.flash_attention(q, k, v, q_offset=off)
        err = float_err(got, want)
        excess = flash_scaled_excess(got, want)
        shares = p_rounding_shares(q, k, v, off, got)
        del want
        print(f"  flash {label}: |err| - rtol |want| at most {excess:.3g} (limit "
              f"{FLASH_ATOL}); outputs rounded otherwise than bf16 of the f32 "
              f"result: kernel {shares['kernel']:.5f}, split P "
              f"{shares['split']:.5f}, bf16 P {shares['bf16']:.5f}", flush=True)
        if not excess <= FLASH_ATOL:
            raise AssertionError(f"flash {label}: {excess} > {FLASH_ATOL}")
        if not (shares["bf16"] > 4 * shares["split"]
                and shares["kernel"] < (shares["split"] + shares["bf16"]) / 2):
            raise AssertionError(f"flash {label}: P.V not kept at more than "
                                 f"bf16 precision: {shares}")

        flash, library = flash_calls(ops, q, k, v, off)
        with sdpa_kernel(backends):
            lib_err = float_err(library().transpose(1, 2), got)
            if not lib_err <= FLASH_TOL:  # the yardstick computes the same
                raise AssertionError(f"SDPA at {label} differs by {lib_err}")
            lib_ms = time_ms(library, reps=FLASH_REPS)
        print(f"  flash {label}: SDPA differs by {lib_err:.3g}", flush=True)
        # admitted keys per query: min(T, q_offset + i + 1); the bytes are
        # q and out once and the K/V rows the mask admits once
        keys = sum(min(t, off + i + 1) for i in range(s))
        need = min(t, off + s)
        n_bytes = 2 * (2 * b * s * h * d + 2 * b * need * kv * d)
        record("flash_attention", label, err, time_ms(flash, reps=FLASH_REPS),
               time_ms(lambda: ref.flash_attention(q, k, v, q_offset=off)),
               lib_ms, n_bytes, 4 * d * h * b * keys, main=main, tol=FLASH_TOL,
               ops_per_s=BF16_FLOPS_PER_S)
        entry = records["flash_attention"][-1]
        entry.update(scaled_excess=excess, p_rounding_shares=shares,
                     library_max_abs_err=lib_err)

        def device_times(entry=entry, label=label, shapes=(q.shape, k.shape), off=off):
            # inputs made anew: the job runs after every path, whose peak
            # memory must not hold these
            g = torch.Generator(device=dev).manual_seed(1)
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                       for shape in (shapes[0], shapes[1], shapes[1]))
            flash, library = flash_calls(ops, q, k, v, off)
            with sdpa_kernel(backends):
                entry["library_device_ms"] = device_ms_per_call(library)
            entry["device_ms"] = device_ms_per_call(flash)
            print(f"  flash {label}: device ms a call (torch.profiler, mean of "
                  f"50) kernel {entry['device_ms']:.5f}, SDPA "
                  f"{entry['library_device_ms']:.5f}", flush=True)

        later.append(device_times)
        del q, k, v
    for b, label, main in ((512, "serve_p99 (512, 39, 10)", False),
                           (262_144, "serve_bulk (262144, 39, 10)", True)):
        x = torch.randn(b, 39, 10, generator=gen, device=dev) * 0.5
        want = ref.fm_interact(x)
        err = float_err(ops.fm_interact(x), want)
        record("fm_interact", label, err,
               time_ms(lambda: ops.fm_interact(x)),
               time_ms(lambda: ref.fm_interact(x)),
               None, 4 * b * 390 + 4 * b, 3 * b * 390, main=main,
               tol=FM_TOL_REL * max(1.0, float(want.abs().max())))


SUM_TOL_REL = 1e-5  # f32 sums in another order: of the sum of |terms|
BF16_TOL_REL = 2.0**-7  # and each rounded once to bf16: one rounding apart
SECTOR = 32  # bytes: the least a random read moves from device memory


def _sum_err(got, want, abs_sum, rel: float = SUM_TOL_REL) -> tuple[float, float]:
    """The largest absolute difference of two f32 sums of the same terms,
    and the limit it is held to: ``rel`` of the largest sum of |terms|.
    Raises if any value differs by more than ``rel`` of its own sum of
    |terms| (plus 1e-6)."""
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= rel * abs_sum + 1e-6).all()):
        raise AssertionError(f"sum differs by {float(diff.max())}, beyond "
                             f"{rel} of its sum of |terms|")
    return float(diff.max()), rel * float(abs_sum.max()) + 1e-6


def touched_sectors(ids, table) -> int:
    """The 32-byte sectors of ``table`` that the rows of the on-table
    ``ids`` lie in, each counted once."""
    row_bytes = table.shape[1] * table.element_size()
    ids = ids.reshape(-1).long()
    ids = ids[(ids >= 0) & (ids < table.shape[0])].unique()
    start = table.data_ptr() % SECTOR + ids * row_bytes
    first, last = start // SECTOR, (start + row_bytes - 1) // SECTOR
    span = torch.arange(-(-row_bytes // SECTOR) + 1, device=ids.device)
    sectors = first[:, None] + span
    return int(sectors[sectors <= last[:, None]].unique().numel())


def segment_bag_kernel_phase(ops, ref, records: dict, dst, dev, later: list) -> None:
    """The segment sum at the GNN path's shapes: the OpenCyc-scale KG's
    2,398,800 edges (``dst``, its real destinations, one node holding
    412,800 of them) into 971,865 nodes, at GatedGCN's width 70 (the main
    path), PNA's 75, the degree counts' 1 and 200 in f32, and 70 in bf16,
    with the plan built once as the forward builds it (its time printed);
    two calls must give the same bits.  The plan's sort (``dedup_order`` of
    the destinations as int64) beside ``torch.sort``.  The
    embedding bag at the FM's shapes: the first-order term of a
    ``serve_bulk`` batch, 262,144 x 39 ids into the (33,763,328, 1)
    weights, each field's ids in its own band of rows (the main path),
    drawn over the whole table and into one field's 865,707 rows, and the
    retrieval query, 1 x 39 ids into the (33,763,328, 10) table."""
    from repro_torch.configs import get_arch

    record = recorder(records)
    gen = torch.Generator(device=dev).manual_seed(2)
    seg = torch.from_numpy(dst).to(dev)
    n, e = FULL_RESOURCES, seg.shape[0]
    keys = seg.to(torch.int64)  # the plan's sort: 5 of 8 digits trivial
    record("dedup_order", f"GNN plan: KG destinations E={e} as int64",
           max_err(ops.dedup_order(keys), ref.dedup_order(keys)),
           time_ms(lambda: ops.dedup_order(keys)),
           time_ms(lambda: ref.dedup_order(keys)),
           time_ms(lambda: torch.sort(keys, stable=True)),
           12 * e, e * log2c(e))
    del keys
    plan = ops.segment_plan(seg, n)
    plan_ms = time_ms(lambda: ops.segment_plan(seg, n))
    print(f"  segment plan of E={e} ids (sort and offsets): {plan_ms:.4f} ms",
          flush=True)

    def plan_device_time(seg=seg):
        print(f"  segment plan of E={e} ids: device "
              f"{device_ms_per_call(lambda: ops.segment_plan(seg, n)):.4f} ms a call",
              flush=True)

    later.append(plan_device_time)

    def device_times(entry, k, dtype, seg=seg):
        """The device time of a call (the wrapper's host work left out: at
        K 1 it is most of a call's event-timed length), on inputs made
        anew: the job runs after every path, whose peak memory must not
        hold these."""
        x = torch.randn(e, k, generator=torch.Generator(device=dev).manual_seed(k),
                        device=dev).to(dtype)
        plan, idx = ops.segment_plan(seg, n), seg.to(torch.int64)
        entry.update(
            device_ms=device_ms_per_call(lambda: ops.segment_sum(x, seg, n, plan=plan)),
            library_device_ms=device_ms_per_call(
                lambda: torch.zeros((n, k), dtype=dtype, device=dev).index_add_(0, idx, x)))
        print(f"  segment_sum {entry['shape']}: device ms a call (torch.profiler) "
              f"kernel {entry['device_ms']:.4f}, index_add_ "
              f"{entry['library_device_ms']:.4f}", flush=True)

    idx = seg.to(torch.int64)
    for k, dtype, main in ((70, torch.float32, True), (75, torch.float32, False),
                           (1, torch.float32, False), (200, torch.float32, False),
                           (70, torch.bfloat16, False)):
        x = torch.randn(e, k, generator=gen, device=dev).to(dtype)
        got = ops.segment_sum(x, seg, n, plan=plan)
        if not torch.equal(got, ops.segment_sum(x, seg, n, plan=plan)):
            raise AssertionError("segment_sum: two calls on the same inputs differ")
        err, tol = _sum_err(got, ref.segment_sum(x, seg, n),
                            ref.segment_sum(x.float().abs(), seg, n),
                            SUM_TOL_REL if dtype == torch.float32 else BF16_TOL_REL)
        del got

        def kernel():
            return ops.segment_sum(x, seg, n, plan=plan)

        def library():
            return torch.zeros((n, k), dtype=dtype, device=dev).index_add_(0, idx, x)

        size = x.element_size()
        record("segment_sum", f"KG in-edges E={e}, n={n}, K={k} {str(dtype)[6:]}",
               err, time_ms(kernel), time_ms(lambda: ref.segment_sum(x, seg, n)),
               time_ms(library), size * e * k + 4 * e + size * n * k, e * k,
               main=main, tol=tol)
        later.append(functools.partial(device_times, records["segment_sum"][-1],
                                       k, dtype))
        del x
    del plan, idx, seg

    spec = get_arch("fm")
    rows, rpf, nf = spec.config.n_rows, spec.config.rows_per_field, spec.config.n_fields
    w1 = torch.randn(rows, 1, generator=gen, device=dev) * 0.01
    table = torch.randn(rows, 10, generator=gen, device=dev) * 0.01
    b = spec.shape("serve_bulk").dims["batch"]
    # the serving path's ids: field f's rows in [f * rpf, (f + 1) * rpf), as
    # ``recsys._row_ids`` lays them out (rho keeps each field apart); ids
    # over the whole table, whose ceiling is the card's rate of random
    # 32-byte reads; and the same ids into one field's rows (3.46 MB, held
    # by L2: the bag's one-launch route at full size, the ceiling that the
    # sweep of the banded ids approaches)
    local = torch.randint(0, rpf, (b, nf), generator=gen, device=dev, dtype=torch.int32)
    banded = (local + torch.arange(nf, device=dev, dtype=torch.int32) * rpf)
    uniform = torch.randint(0, rows, (b, nf), generator=gen, device=dev,
                            dtype=torch.int32)
    for ids, tab, label, main in (
        (banded, w1, f"serve_bulk first order ({b}, {nf}) banded by field "
                     f"into ({rows}, 1)", True),
        (uniform, w1, f"serve_bulk first order ({b}, {nf}) uniform over "
                      f"({rows}, 1)", False),
        (local, w1[:rpf], f"serve_bulk first order ({b}, {nf}) into one "
                          f"field's rows ({rpf}, 1)", False),
        (banded[:1].contiguous(), table,
         f"retrieval query (1, {nf}) into ({rows}, 10)", False),
    ):
        bags, k = ids.shape[0], tab.shape[1]
        err, tol = _sum_err(ops.embedding_bag(ids, tab), ref.embedding_bag(ids, tab),
                            ref.embedding_bag(ids, tab.abs()))
        # the ids, each 32-byte sector of the table that they touch once,
        # and the sums
        record("embedding_bag", label, err,
               time_ms(lambda: ops.embedding_bag(ids, tab)),
               time_ms(lambda: ref.embedding_bag(ids, tab)),
               time_ms(lambda: F.embedding_bag(ids, tab, mode="sum")),
               4 * bags * nf + SECTOR * touched_sectors(ids, tab) + 4 * bags * k,
               bags * nf * k, main=main, tol=tol)
        entry = records["embedding_bag"][-1]
        # the bound as if every lookup read its row's sectors from device
        # memory: ceil(4K / 32) sectors a lookup, none of them held by L2
        row_bytes = -(-4 * k // SECTOR) * SECTOR
        entry["lookup_sectors_bound_ms"], _ = bound(
            4 * bags * nf + row_bytes * bags * nf + 4 * bags * k, bags * nf * k)
        # a plain gather of the same rows, no sum: the measured ceiling of
        # these random reads, beside the library's bag
        ids64 = ids.to(torch.int64)
        entry["gather_ms"] = time_ms(lambda: tab[ids64])
        print(f"  embedding_bag {label}: plain gather tab[ids] "
              f"{entry['gather_ms']:.4f} ms", flush=True)
    del w1, table, banded, uniform, local, ids64


LM_REQUESTS, LM_SLOTS, LM_MAX_LEN, LM_NEW = 64, 16, 1024, 32
LM_LOGIT_TOL = 0.25  # bf16 logits below 8 after 30 bf16 layers: 8 units in the last place


def _tree_to(tree, dev):
    """A parameter tree (dicts, lists, tuples of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree.to(dev)


def _teacher_forced_logits(lm, params, cfg, req) -> torch.Tensor:
    """Prefill the prompt, then feed the request's own generated tokens one
    decode step at a time (scalar positions: the flash kernel on the card);
    the logits of every step, f32 on the host."""
    dev = params["embed"].device
    logits, cache = lm.prefill(params, cfg, torch.tensor([req.prompt], device=dev))
    plen = len(req.prompt)
    arena = lm.init_cache(cfg, 1, plen + len(req.out), device=dev)
    for key in arena:
        arena[key][:, :, :plen] = cache[key]
    out = [logits[0, -1].float().cpu()]
    for i, tok in enumerate(req.out[:-1]):
        logits, arena = lm.decode_step(params, cfg, arena,
                                       torch.tensor([tok], device=dev), plen + i)
        out.append(logits[0].float().cpu())
    return torch.stack(out)


def lm_server():
    """SmolLM-135M at full width with the flash kernel (random weights from
    seed 0), and ``serve(n)``: a ServeEngine with the first n of the 64
    seeded requests submitted."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as lm
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_arch("smollm-135m").config, attn_impl="flash")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, LM_REQUESTS)]

    def serve(n_requests: int):
        eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_id=-1)
        for i, p in enumerate(prompts[:n_requests]):
            eng.submit(Request(uid=i, prompt=p, max_new=LM_NEW))
        return eng

    return cfg, params, serve


def lm_serving_phase(ops, records: dict, later: list) -> int:
    """Phase 6; its profiled rerun goes to ``later``."""
    from repro_torch.models import transformer as lm

    cfg, params, serve = lm_server()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"],
                                       *params["layers"].values()])
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, want {cfg.param_count()}")

    warm = serve(2)  # first-call costs (cuBLAS handles, the kernel's module)
    warm.run()
    torch.cuda.synchronize()
    del warm
    eng = serve(LM_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if sorted(r.uid for r in done) != list(range(LM_REQUESTS)):
        raise AssertionError("not every request finished")
    if any(len(r.out) != LM_NEW for r in done):
        raise AssertionError("a request stopped short of max_new")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if launches["flash_attention"] != LM_REQUESTS * cfg.n_layers:
        raise AssertionError(f"flash launches {launches['flash_attention']}, want "
                             f"{LM_REQUESTS * cfg.n_layers}")
    st = eng.stats
    outs = {r.uid: r.out for r in done}

    def profile_rerun():
        """The first wave of the traffic (one request per slot) again, under
        torch.profiler, for the device's busy share and the flash kernel's;
        the model made anew (the same seed), so that the paths between hold
        none of it."""
        _, _, serve = lm_server()
        for session in range(1, PROFILE_SESSIONS + 1):
            again = serve(LM_SLOTS)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                again_done = again.run()
                torch.cuda.synchronize()
                profiled_wall = time.perf_counter() - t0
            busy = device_time(prof, profiled_wall)
            if busy["busy_ms"] > 0:
                break
            lost_session(session)
        else:
            raise AssertionError("torch.profiler saw no device time")
        flash_ms = busy["port_kernels_ms"].get("flash_attention", 0.0)
        busy["flash_share_of_wall"] = flash_ms / 1e3 / profiled_wall
        busy["flash_share_of_busy"] = flash_ms / busy["busy_ms"]
        rerun = dict(profiled_requests=LM_SLOTS, profiled_wall_s=profiled_wall,
                     profiled_same_tokens=all(outs[r.uid] == r.out
                                              for r in again_done),
                     device_time=busy)
        # the whole traffic again, now that the process has run torch.profiler
        after = serve(LM_REQUESTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after.run()
        torch.cuda.synchronize()
        rerun["wall_after_profiling_s"] = time.perf_counter() - t0
        print(f"  LM serving, profiled rerun: {json.dumps(rerun)}", flush=True)
        records["lm_serving"].update(rerun)

    later.append(profile_rerun)

    # card against CPU: teacher-forced logits of the shortest and the longest
    # request
    by_len = sorted(done, key=lambda r: len(r.prompt))
    cpu_params = _tree_to(params, "cpu")
    t0 = time.perf_counter()
    errs = []
    for req in (by_len[0], by_len[-1]):
        card = _teacher_forced_logits(lm, params, cfg, req)
        host = _teacher_forced_logits(lm, cpu_params, cfg, req)
        errs.append(float((card - host).abs().max()))
        if not errs[-1] <= LM_LOGIT_TOL:
            raise AssertionError(f"request {req.uid}: card and CPU logits differ by "
                                 f"{errs[-1]} > {LM_LOGIT_TOL}")
        if not torch.isfinite(card).all():
            raise AssertionError("non-finite logits")
    cpu_s = time.perf_counter() - t0
    gen_tokens = LM_REQUESTS * LM_NEW
    out = dict(
        config=cfg.name, params=n_params, requests=LM_REQUESTS, slots=LM_SLOTS,
        max_len=LM_MAX_LEN, max_new=LM_NEW,
        prompt_tokens=st.prefill_tokens, wall_s=wall,
        generated_tokens_per_s=gen_tokens / wall,
        prefill_s=st.prefill_seconds,
        prefill_tokens_per_s=st.prefill_tokens / st.prefill_seconds,
        decode_steps=st.decode_steps, decode_tokens=st.decode_tokens,
        decode_s=st.decode_seconds,
        decode_tokens_per_s=st.decode_tokens / st.decode_seconds,
        arena_bytes=sum(t.numel() * t.element_size() for t in eng.cache.values()),
        max_memory_allocated=peak, launches=launches,
        teacher_forced=dict(uids=[by_len[0].uid, by_len[-1].uid],
                            prompt_lens=[len(by_len[0].prompt), len(by_len[-1].prompt)],
                            max_abs_err=errs, tol=LM_LOGIT_TOL, cpu_s=cpu_s),
    )
    print(f"  {json.dumps(out)}", flush=True)
    records["lm_serving"] = out
    return launches["flash_attention"]


FM_MERGE_PAIRS = 1 << 20


def fm_model() -> dict:
    """The Criteo-scale FM with the kernels (seeded weights and non-zero
    first-order weights), a rho made by the port's union-find from 2^20
    seeded merge pairs inside fields (and its wall), and the ``serve_p99``
    and ``serve_bulk`` batches; ``rng`` is left where the batches end."""
    from repro_torch.configs import get_arch
    from repro_torch.core.uf import merge_pairs
    from repro_torch.models import recsys

    spec = get_arch("fm")
    cfg = dataclasses.replace(spec.config, use_pallas=True)
    rpf = cfg.rows_per_field
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = recsys.init_params(gen, cfg)
    # non-zero first-order weights, so that their bag counts in the scores
    params["w1"] = torch.randn(cfg.n_rows, generator=gen, device="cuda") * 0.01
    rng = np.random.default_rng(0)
    field = rng.integers(0, cfg.n_fields, FM_MERGE_PAIRS)
    a, b = rng.integers(0, rpf, (2, FM_MERGE_PAIRS)) + field * rpf
    pairs = torch.from_numpy(np.stack([a, b], axis=1).astype(np.int32)).cuda()
    rep = torch.arange(cfg.n_rows, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    rho = merge_pairs(rep, pairs, torch.ones(FM_MERGE_PAIRS, dtype=torch.bool,
                                             device="cuda"))
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    batches = {}
    for name in ("serve_p99", "serve_bulk"):
        n = spec.shape(name).dims["batch"]
        ids = rng.integers(0, rpf, (n, cfg.n_fields)).astype(np.int32)
        batches[name] = {"ids": torch.from_numpy(ids).cuda(), "rho": rho}
    torch.cuda.synchronize()
    return dict(spec=spec, cfg=cfg, params=params, rep=rep, rho=rho,
                merge_s=merge_s, batches=batches, rng=rng)


def fm_serving_phase(ops, records: dict, later: list) -> int:
    """Phase 7; its profiled rerun of the bulk batch goes to ``later``."""
    from repro_torch.models import recsys

    fm = fm_model()
    spec, cfg, params, rep, rho, batches, rng = (
        fm[k] for k in ("spec", "cfg", "params", "rep", "rho", "batches", "rng"))
    rpf = cfg.rows_per_field
    table_bytes = params["table"].numel() * 4
    merged = rho != rep
    n_merged = int(merged.sum())
    if not torch.equal(rho[rho.long()], rho) or not (rho <= rep).all():
        raise AssertionError("rho is not a compressed min-representative map")
    if not torch.equal(rho.long() // rpf, rep.long() // rpf):
        raise AssertionError("rho merges rows of two fields")
    ops.reset_launches()
    scores, times = {}, {}
    for name, batch in batches.items():
        recsys.serve_step(params, cfg, batch)  # warm-up, outside the times
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            scores[name] = recsys.serve_step(params, cfg, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        times[name] = walls
    # one user against the retrieval_cand candidates
    n_cand = spec.shape("retrieval_cand").dims["n_candidates"]
    user = torch.from_numpy(rng.integers(0, rpf, (1, cfg.n_fields)).astype(np.int32)).cuda()
    cand = torch.from_numpy(rng.integers(0, cfg.n_rows, n_cand).astype(np.int32)).cuda()
    recsys.retrieval_scores(params, cfg, user, cand)  # warm-up
    retrieval_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        retrieval = recsys.retrieval_scores(params, cfg, user, cand)
        torch.cuda.synchronize()
        retrieval_walls.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    if launches["fm_interact"] != 12:
        raise AssertionError(f"fm_interact launches {launches['fm_interact']}, want 12")
    if launches["embedding_bag"] != 12 + 6:  # a bag per serve_step and per query
        raise AssertionError(f"embedding_bag launches {launches['embedding_bag']}, "
                             "want 18")
    if retrieval.shape != (n_cand,) or not torch.isfinite(retrieval).all():
        raise AssertionError("retrieval scores misshaped or not finite")
    for name, sc in scores.items():
        n = batches[name]["ids"].shape[0]
        if sc.shape != (n,) or not torch.isfinite(sc).all() or \
                not ((sc > 0) & (sc < 1)).all():
            raise AssertionError(f"{name}: scores out of (0, 1) or misshaped")

    # merged IDs score the same: members of merged cliques against their
    # representatives, one member per row in a seeded batch
    merged_ids = torch.nonzero(merged).flatten()
    pick = torch.randperm(merged_ids.numel(), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    members = merged_ids[pick[:512]]
    ids = batches["serve_p99"]["ids"][:members.numel()].clone()
    rep_ids = ids.clone()
    rows = torch.arange(members.numel(), device="cuda")
    field = members // rpf
    ids[rows, field] = (members % rpf).to(torch.int32)
    rep_ids[rows, field] = (rho[members].long() % rpf).to(torch.int32)
    sa = recsys.serve_step(params, cfg, {"ids": ids, "rho": rho})
    sb = recsys.serve_step(params, cfg, {"ids": rep_ids, "rho": rho})
    if not torch.equal(sa, sb):
        raise AssertionError("merged IDs score differently from their representatives")

    # card against CPU at batch 512
    t0 = time.perf_counter()
    cpu_params = _tree_to(params, "cpu")
    host = recsys.serve_step(cpu_params, cfg, _tree_to(batches["serve_p99"], "cpu"))
    cpu_s = time.perf_counter() - t0
    err = float((scores["serve_p99"].cpu() - host).abs().max())
    if not torch.allclose(scores["serve_p99"].cpu(), host, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"FM: card and CPU differ by {err}")
    host_retrieval = recsys.retrieval_scores(cpu_params, cfg, user.cpu(), cand.cpu())
    retrieval_err = float((retrieval.cpu() - host_retrieval).abs().max())
    if not torch.allclose(retrieval.cpu(), host_retrieval, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"FM retrieval: card and CPU differ by {retrieval_err}")
    out = dict(
        config=cfg.name, n_rows=cfg.n_rows, table_bytes=table_bytes,
        merge_pairs=FM_MERGE_PAIRS, merged_rows=n_merged, merge_s=fm["merge_s"],
        serve_wall_s={k: statistics.median(v) for k, v in times.items()},
        serve_walls_s=times,
        rows_per_s={k: batches[k]["ids"].shape[0] / statistics.median(v)
                    for k, v in times.items()},
        retrieval_candidates=n_cand,
        retrieval_wall_s=statistics.median(retrieval_walls),
        retrieval_walls_s=retrieval_walls,
        launches=launches, merged_checked=int(members.numel()),
        card_vs_cpu_max_abs_err=err, retrieval_card_vs_cpu_max_abs_err=retrieval_err,
        cpu_s=cpu_s,
    )
    print(f"  {json.dumps(out)}", flush=True)
    records["fm_serving"] = out

    def profile_rerun():
        """The bulk batch's serve_step again under torch.profiler (the
        second of two steps), on the model made anew from the same seeds:
        device ms per port kernel and per glue kernel, and the busy share."""
        fm = fm_model()
        batch = fm["batches"]["serve_bulk"]
        prof, wall, _ = profiled(lambda: recsys.serve_step(fm["params"], fm["cfg"], batch))
        busy = device_time(prof, wall)
        if busy["busy_ms"] <= 0:
            raise AssertionError("torch.profiler saw no device time")
        for name in ("fm_interact", "embedding_bag"):
            if busy["port_kernels_ms"].get(name, 0.0) <= 0:
                raise AssertionError(f"FM profile: no device time of {name}")
        rerun = dict(profiled_batch=int(batch["ids"].shape[0]), profiled_wall_s=wall,
                     device_time=busy)
        print(f"  FM serving, profiled serve_step of serve_bulk: {json.dumps(rerun)}",
              flush=True)
        records["fm_serving"].update(rerun)

    later.append(profile_rerun)
    return launches


# of the largest |logit|: f32 sums and products in other orders.  Measured
# on an NVIDIA H100 80GB HBM3 at 700 W: at most 4.9e-5 (PNA on
# full_graph_sm, logits up to 5.2), 7.6e-6 for GatedGCN's 16 layers; both
# computations are deterministic, so the error does not move between runs.
GNN_TOL_REL = 1e-4


def _check_logits(card: torch.Tensor, host: torch.Tensor, label: str) -> float:
    """The card's logits are finite and within ``GNN_TOL_REL`` of the
    CPU's (relative to the largest CPU logit, at least 1)."""
    card = card.cpu()
    if card.shape != host.shape or not torch.isfinite(card).all():
        raise AssertionError(f"{label}: logits misshaped or not finite")
    err = float((card - host).abs().max())
    limit = GNN_TOL_REL * max(1.0, float(host.abs().max()))
    print(f"  {label}: card vs cpu max_abs_err {err:.3g} (limit {limit:.3g})",
          flush=True)
    if not err <= limit:
        raise AssertionError(f"{label}: card and CPU logits differ by {err} > {limit}")
    return err


def _synced_walls(fn, reps: int = 3):
    """``fn()`` once to warm up, then ``reps`` runs each ending in a
    synchronise: the outputs and the host walls."""
    fn()
    torch.cuda.synchronize()
    outs, walls = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return outs, walls


def gnn_phase(ops, records: dict, kg: dict) -> int:
    """Phase 8; returns the segment sum's launches on the main path (the
    full-size dedup and one GatedGCN forward on its graph)."""
    from repro_torch import TorchEngine
    from repro_torch.configs import get_arch
    from repro_torch.data.generator import PROFILES, generate
    from repro_torch.data.graphs import build_graph_from_kg, dedup_graph, graph_to, random_graph
    from repro_torch.models.gnn import gatedgcn, pna

    errs = {}
    # 1. full width on full_graph_sm, card against CPU, the same weights
    dims = get_arch("gatedgcn").shape("full_graph_sm").dims
    for name, mod in (("gatedgcn", gatedgcn), ("pna", pna)):
        cfg = get_arch(name).config
        graph = random_graph(np.random.default_rng(0), dims["n_nodes"], dims["n_edges"],
                             dims["d_feat"], cfg.n_classes)
        params = mod.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        host = mod.forward(params, cfg, graph_to(graph, "cpu"))
        card = mod.forward(_tree_to(params, "cuda"), cfg, graph_to(graph, "cuda"))
        errs[f"{name} full_graph_sm"] = _check_logits(card, host, f"{name} full_graph_sm")

    # 2. the mid-size KG: rho, the deduplicated graph and GatedGCN at full
    # width (16 node features, as examples/kg_dedup_gnn.py gives them)
    cfg = dataclasses.replace(get_arch("gatedgcn").config, d_in=16)
    facts, program, dic = generate(**PROFILES["opencyc_like"])
    reps = [TorchEngine(dic.n_resources, device=d).materialise(facts, program)[1]
            for d in ("cuda", "cpu")]
    if not np.array_equal(reps[0], reps[1]):
        raise AssertionError("mid-size KG: rho differs between cuda and cpu")
    graph = build_graph_from_kg(facts, dic.n_resources, 16, np.random.default_rng(0))
    card_dd, host_dd = dedup_graph(graph, reps[0], "cuda"), dedup_graph(graph, reps[1], "cpu")
    for key in host_dd:
        if not torch.equal(card_dd[key].cpu(), host_dd[key]):
            raise AssertionError(f"mid-size KG: deduplicated {key} differs from the CPU's")
    params = gatedgcn.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card_params = _tree_to(params, "cuda")
    mid = dict(edges=int(graph["edge_index"].shape[1]),
               dedup_edges=int(host_dd["edge_index"].shape[1]))
    for label, card_g, host_g in (("raw", graph_to(graph, "cuda"), graph_to(graph, "cpu")),
                                  ("dedup", card_dd, host_dd)):
        errs[f"gatedgcn mid-size KG {label}"] = _check_logits(
            gatedgcn.forward(card_params, cfg, card_g),
            gatedgcn.forward(params, cfg, host_g), f"gatedgcn mid-size KG {label}")

    # 3. full size, from phase 5's facts and rho
    n = kg["dic"].n_resources
    t0 = time.perf_counter()
    graph = build_graph_from_kg(kg["facts"], n, 16, np.random.default_rng(0))
    raw = graph_to(graph, "cuda")
    build_s = time.perf_counter() - t0
    if raw["edge_index"].shape[1] != FULL_EDGES:
        raise AssertionError(f"raw graph: {raw['edge_index'].shape[1]} edges")
    rho = torch.from_numpy(kg["rho"]).cuda()
    params = gatedgcn.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    gatedgcn.forward(params, cfg, raw)  # first-call costs, outside the count
    torch.cuda.synchronize()
    ops.reset_launches()
    dedup = dedup_graph(raw, rho, "cuda")
    logits = gatedgcn.forward(params, cfg, dedup)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = dict(segment_sum=2 * cfg.n_layers, rewrite_triples=1, dedup_order=2,
                search_bounds=1)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"main path launches {launches}, want {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("full size: non-finite logits")
    dd_outs, dedup_walls = _synced_walls(lambda: dedup_graph(raw, rho, "cuda"))
    if not all(torch.equal(d["edge_index"], dedup["edge_index"]) for d in dd_outs):
        raise AssertionError("dedup_graph differs between runs")
    del dd_outs

    runs = {}
    for label, g in (("raw", raw), ("dedup", dedup)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs, walls = _synced_walls(lambda: gatedgcn.forward(params, cfg, g))
        peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(outs[0]).all():
            raise AssertionError(f"{label}: non-finite logits")
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"{label}: two card forwards differ")
        e = int(g["edge_index"].shape[1])
        deg = torch.bincount(g["edge_index"][1].to(torch.int64), minlength=n)
        wall = statistics.median(walls)
        runs[label] = dict(edges=e, max_in_degree=int(deg.max()),
                           nodes_with_in_edges=int((deg > 0).sum()),
                           wall_s=wall, walls_s=walls, edges_per_s=e / wall,
                           max_memory_allocated=peak)
        del outs
    if not torch.equal(logits, gatedgcn.forward(params, cfg, dedup)):
        raise AssertionError("dedup: the main path's forward differs from a rerun")

    # PNA at full width on the deduplicated graph
    pcfg = dataclasses.replace(get_arch("pna").config, d_in=16)
    pparams = pna.init_params(torch.Generator(device="cuda").manual_seed(0), pcfg)
    before = ops.LAUNCHES["segment_sum"]
    torch.cuda.reset_peak_memory_stats()
    pouts, pwalls = _synced_walls(lambda: pna.forward(pparams, pcfg, dedup))
    per_forward = (ops.LAUNCHES["segment_sum"] - before) / 4
    if per_forward != 8 * pcfg.n_layers + 1:
        raise AssertionError(f"PNA: {per_forward} segment sums a forward")
    if not all(torch.isfinite(o).all() for o in pouts):
        raise AssertionError("PNA: non-finite logits")

    # the forward on the deduplicated graph again, under torch.profiler;
    # its first kernels are the segment plan's sort and search
    prof, profiled_wall, _ = profiled(lambda: gatedgcn.forward(params, cfg, dedup))
    busy = device_time(prof, profiled_wall)
    if busy["busy_ms"] <= 0:
        raise AssertionError("torch.profiler saw no device time")
    kernel_ms = busy["port_kernels_ms"]
    busy["segment_sum_share_of_busy"] = kernel_ms.get("segment_sum", 0.0) / busy["busy_ms"]
    print(f"  profiled forward: segment_sum {kernel_ms.get('segment_sum', 0.0):.3f} "
          f"ms; the plan's dedup_order {kernel_ms.get('dedup_order', 0.0):.4f} ms "
          f"and search_bounds {kernel_ms.get('search_bounds', 0.0):.4f} ms",
          flush=True)

    live = int((rho == torch.arange(n, dtype=torch.int32, device="cuda")).sum())
    out = dict(
        card_vs_cpu_max_abs_err=errs, tol_rel=GNN_TOL_REL, midsize_kg=mid,
        nodes=n, live_nodes=live, graph_build_s=build_s,
        dedup_wall_s=statistics.median(dedup_walls), dedup_walls_s=dedup_walls,
        gatedgcn=dict(config=cfg.name, n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
                      d_in=cfg.d_in, **{label: r for label, r in runs.items()}),
        pna=dict(config=pcfg.name, n_layers=pcfg.n_layers, d_hidden=pcfg.d_hidden,
                 edges=runs["dedup"]["edges"], wall_s=statistics.median(pwalls),
                 walls_s=pwalls, segment_sums_per_forward=per_forward,
                 max_memory_allocated=torch.cuda.max_memory_allocated()),
        launches=launches, profiled_wall_s=profiled_wall, device_time=busy,
    )
    print(f"  {json.dumps(out)}", flush=True)
    records["gnn"] = out
    return launches["segment_sum"]


COUNTERS = ("derivations", "rule_applications", "merged_resources",
            "reflexive_added", "rounds", "triples_total")
MIDSIZE = ("opencyc_like", "merge_like", "chain_like", "claros_like")


def same_result(label: str, got, want) -> None:
    """Raise unless two ``(triples, rho, stats)`` results hold the same
    triples, rho and counters."""
    from repro_torch.core.triples import pack

    if not np.array_equal(np.sort(pack(got[0])), np.sort(pack(want[0]))):
        raise AssertionError(f"{label}: triples differ")
    if not np.array_equal(got[1], want[1]):
        raise AssertionError(f"{label}: rho differs")
    for k in COUNTERS:
        if getattr(got[2], k) != getattr(want[2], k):
            raise AssertionError(f"{label}: {k} differs")


def midsize_phase(records: dict) -> None:
    """Each mid-size profile through the default (fused) engine and the host
    loop, on the card and on the CPU: the same triples, rho and counters.  Then Theorem 1 of the card's fused
    result against the port's host AX materialisation."""
    from repro_torch import TorchEngine
    from repro_torch.core.materialise import MatResult, check_theorem1, materialise_ax
    from repro_torch.core.triples import TripleArena
    from repro_torch.data.generator import PROFILES, generate

    for name in MIDSIZE:
        facts, program, dic = generate(**PROFILES[name])
        runs, walls = {}, {}
        for label, device, kw in (("cuda", "cuda", {}),
                                  ("cuda_host_loop", "cuda", dict(fuse_rounds=False)),
                                  ("cpu", "cpu", {}),
                                  ("cpu_host_loop", "cpu", dict(fuse_rounds=False))):
            t0 = time.perf_counter()
            eng = TorchEngine(dic.n_resources, device=device, **kw)
            runs[label] = eng.materialise(facts, program)
            walls[f"{label}_wall_s"] = time.perf_counter() - t0
            if label == "cuda" and eng._graph is None:
                raise AssertionError(f"{name}: the fused run captured no graph")
        for label in ("cuda_host_loop", "cpu", "cpu_host_loop"):
            same_result(f"{name}: cuda (fused) vs {label}", runs[label], runs["cuda"])
        spo, rep, stats = runs["cuda"]
        t0 = time.perf_counter()
        ax = materialise_ax(facts, program, dic.n_resources)
        walls["host_ax_s"] = time.perf_counter() - t0
        arena = TripleArena()
        arena.add_batch(spo)
        t0 = time.perf_counter()
        check_theorem1(MatResult(arena, rep, program, stats), ax)
        walls["theorem1_s"] = time.perf_counter() - t0
        counters = {k: getattr(stats, k) for k in COUNTERS}
        print(f"  {name}: cuda fused == cuda host loop == cpu fused == cpu host "
              f"loop, {counters}; "
              f"Theorem 1 holds against the host AX ({ax.stats.triples_unmarked} "
              f"triples); {json.dumps(walls)}", flush=True)
        records[name] = dict(counters, rule_rewrites=stats.rule_rewrites,
                             ax_triples=ax.stats.triples_unmarked, **walls)


def full_kg() -> dict:
    """The OpenCyc-scale KG (phase 5's input; its edges are phase 8's
    graph and phase 3's segment ids), generated once on the host."""
    from repro_torch.data.generator import PROFILES, generate

    config = dict(PROFILES["opencyc_like"], **FULL)
    t0 = time.perf_counter()
    facts, program, dic = generate(**config)
    gen_s = time.perf_counter() - t0
    print(f"  generated {facts.shape[0]} triples, {dic.n_resources} resources "
          f"in {gen_s:.1f} s", flush=True)
    if facts.shape[0] != FULL_EDGES:
        raise AssertionError(f"{facts.shape[0]} triples, want {FULL_EDGES}")
    return dict(facts=facts, program=program, dic=dic, config=config, gen_s=gen_s)


def split_summary(split: dict) -> dict:
    """An engine's ``last_split`` with each round's numbers as lists."""
    rounds = split["rounds"]
    return dict(
        setup_s=split["setup_s"], round_wall_s=[r["wall_s"] for r in rounds],
        round_wait_s=[r["wait_s"] for r in rounds],
        round_reads=[r["reads"] for r in rounds], between_s=split["between_s"],
        stats_s=split["stats_s"], wall_s=split["wall_s"], reads=split["reads"],
        capture_s=split.get("capture_s"),
    )


def rew_run(ops, eng, facts, program):
    """One materialisation on the card: its state, and its wall (ending in
    a synchronise), launch counts (set to 0 just before), peak memory
    allocated and reserved (the caching allocator's segments, a CUDA
    graph's private pool included) and the engine's wall split."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = eng.materialise_state(facts, program)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, dict(
        wall_s=wall, launches=dict(ops.LAUNCHES),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        max_memory_reserved=torch.cuda.max_memory_reserved(),
        allocated_before=before, split=split_summary(eng.last_split),
    )


def quiet_sweep_ms(ops, state) -> dict:
    """CUDA-event times (median of 5) of the store sweep on a quiet round,
    where rho changes no live row: the rewrite alone (both loops run it
    every round), and the rewrite with the compaction of the swept rows and
    their removal from the index, which the fused loop runs every round and
    the host loop only when a row changed."""
    from repro_torch.core.engine import _compact, _index_remove

    arena_cap = state.spo.shape[0] - 1

    def rewrite():
        return ops.rewrite_triples(state.spo, state.rep, epoch=state.epoch,
                                   marked=state.marked)

    def sweep():
        rewritten, changed = rewrite()
        _compact({"s": rewritten[:, 0], "p": rewritten[:, 1], "o": rewritten[:, 2]},
                 changed, FULL_CAP)
        _index_remove(state.sort_perm, state.sorted_keys, changed, arena_cap)

    if bool(rewrite()[1].any()):
        raise AssertionError("the fixpoint's store is not quiet under its rho")
    rewrite_ms, sweep_ms = time_ms(rewrite), time_ms(sweep)
    return dict(rewrite_ms=rewrite_ms, sweep_ms=sweep_ms,
                compaction_and_removal_ms=sweep_ms - rewrite_ms)


def fullsize_phase(ops, records: dict, kg: dict, later: list) -> dict:
    """REW at full size on ``kg``; leaves the card's rho in ``kg["rho"]``.

    The host loop (``fuse_rounds=False``) runs three times first, then the
    default engine: its first run (round 1 eager, the capture of the round
    graph, a replay a round after) is the main path's run, and three more
    replay the graph from round 1.  Each run's wall split, peak memory and
    launches are kept.  The old entry's host work (``dedup_rows`` of the
    facts) is timed on its own and after a host-loop run in one span, and
    the numpy host REW once.  Profiled reruns
    of both loops and the search census (on the host loop, whose search
    calls a wrapper can count) go to ``later``."""
    from repro_torch import TorchEngine
    from repro_torch.core.engine import index_invariant_report
    from repro_torch.core.materialise import materialise_rew
    from repro_torch.core.triples import dedup_rows

    facts, program, dic, config = kg["facts"], kg["program"], kg["dic"], kg["config"]
    if dic.n_resources != FULL_RESOURCES:
        raise AssertionError(f"{dic.n_resources} resources, want {FULL_RESOURCES}")
    caps = dict(capacity=FULL_CAP, bind_cap=FULL_CAP, out_cap=FULL_CAP,
                rewrite_cap=FULL_CAP)
    t0 = time.perf_counter()
    n_distinct = dedup_rows(facts).shape[0]
    dedup_rows_s = time.perf_counter() - t0

    host_eng = TorchEngine(dic.n_resources, device="cuda", fuse_rounds=False, **caps)
    torch.cuda.empty_cache()
    host_runs, host_result = [], None
    for _ in range(3):
        hstate, run = rew_run(ops, host_eng, facts, program)
        host_runs.append(run)
        if host_result is None:
            host_result = (host_eng.state_triples(hstate), host_eng.state_rep(hstate),
                           hstate.stats)
        del hstate
    print(f"  host loop: walls {[r['wall_s'] for r in host_runs]}, peak memory "
          f"allocated {host_runs[0]['max_memory_allocated']} reserved "
          f"{host_runs[0]['max_memory_reserved']} B, split of the first "
          f"{json.dumps(host_runs[0]['split'])}", flush=True)
    # the parent's entry: the same run, then dedup_rows of the facts on the
    # host for triples_explicit, in one span
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hstate = host_eng.materialise_state(facts, program)
    dedup_rows(facts)
    torch.cuda.synchronize()
    host_with_dedup_rows_s = time.perf_counter() - t0
    del hstate

    eng = TorchEngine(dic.n_resources, device="cuda", **caps)
    torch.cuda.empty_cache()
    state, first = rew_run(ops, eng, facts, program)
    wall, launches, stats = first["wall_s"], first["launches"], state.stats
    graph = eng._graph
    if graph is None or graph.graph is None:
        raise AssertionError("the fused run captured no round graph")
    if first["split"]["round_reads"] != [1] * stats.rounds:
        raise AssertionError(f"fused rounds read {first['split']['round_reads']}")
    if stats.capacity_retries:
        raise AssertionError(f"{stats.capacity_retries} capacity restarts at full size")
    print(f"  fused, first run: wall {wall:.4f} s, capture of the round graph "
          f"{graph.capture_s:.4f} s, {stats.rounds} rounds ({stats.rounds - 1} "
          f"replays), a replay launches {json.dumps(graph.launches)}; peak memory "
          f"allocated {first['max_memory_allocated']} reserved "
          f"{first['max_memory_reserved']} B", flush=True)
    print(f"  fused, split of the first run {json.dumps(first['split'])}", flush=True)

    rho = torch.from_numpy(eng.state_rep(state))
    if stats.merged_resources != FULL_MERGED:
        raise AssertionError(f"merged_resources {stats.merged_resources} != {FULL_MERGED}")
    if stats.triples_explicit != n_distinct:
        raise AssertionError(f"triples_explicit {stats.triples_explicit} != {n_distinct}")
    members = np.asarray([
        [dic.id_of(f":e{g}_{i}") for i in range(config["group_size"])]
        for g in range(config["n_groups"])
    ])
    if not (rho.numpy()[members] == members.min(axis=1, keepdims=True)).all():
        raise AssertionError("a group does not map to its minimum member")
    if not torch.equal(rho[rho.to(torch.int64)], rho):
        raise AssertionError("rho is not idempotent")
    live = eng.state_triples(state)
    if not (rho.numpy()[live] == live).all():
        raise AssertionError("a live row holds a non-representative ID")
    problems = index_invariant_report(state)
    if problems:
        raise AssertionError(f"index invariant: {problems}")
    missing = [k for k in REW_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # the engine merges once a round: one union and one compression each
    if not launches["uf_union"] == launches["uf_compress"] == stats.rounds:
        raise AssertionError(f"{stats.rounds} rounds launched "
                             f"{launches['uf_union']} unions and "
                             f"{launches['uf_compress']} compressions")
    card = (live, rho.numpy(), stats)
    same_result("full size: fused vs host loop", host_result, card)
    quiet = quiet_sweep_ms(ops, state)
    print(f"  a quiet round's sweep on the fixpoint's store: {json.dumps(quiet)}",
          flush=True)
    del state

    # three more runs replay the captured graph from round 1
    reruns = []
    for _ in range(3):
        again, run = rew_run(ops, eng, facts, program)
        if eng._graph is not graph or graph.graph is None:
            raise AssertionError("a rerun captured the round graph again")
        for k in COUNTERS:
            if getattr(again.stats, k) != getattr(stats, k):
                raise AssertionError(f"fused rerun: {k} differs")
        reruns.append(run)
        del again
    print(f"  fused, reruns: walls {[r['wall_s'] for r in reruns]}, split of each "
          f"{json.dumps([r['split'] for r in reruns])}", flush=True)

    def profile_rerun():
        profiled_out = {}
        for label, e in (("profiled_fused", eng), ("profiled_host_loop", host_eng)):
            prof, profiled_wall, _ = profiled(lambda e=e: e.materialise_state(facts, program))
            busy = device_time(prof, profiled_wall)
            busy["share_of_unprofiled_wall"] = busy["busy_ms"] / 1e3 / (
                reruns[0]["wall_s"] if e is eng else host_runs[1]["wall_s"])
            profiled_out[label] = dict(profiled_wall_s=profiled_wall, device_time=busy)
        census = search_census(ops, lambda: host_eng.materialise_state(facts, program))
        profiled_out["search_census_host_loop"] = census
        print(f"  REW, profiled reruns of both loops and the host loop's search "
              f"calls by form and size: {json.dumps(profiled_out)}", flush=True)
        records["fullsize"].update(profiled_out)

    later.append(profile_rerun)

    # the numpy host REW (the paper's algorithm in bulk on the host)
    t0 = time.perf_counter()
    rew = materialise_rew(facts, program, dic.n_resources)
    host_rew_s = time.perf_counter() - t0
    same_result("full size: card vs numpy host REW",
                (rew.triples(), rew.rep, rew.stats), card)
    print(f"  numpy host REW: {host_rew_s:.2f} s, the same triples, rho and "
          f"counters; dedup_rows of the facts: {dedup_rows_s:.4f} s", flush=True)

    # the same run on the host's CPU, through the kernels' plain versions,
    # under both loops
    cpu_walls = {}
    for label, kw in (("fused", {}), ("host_loop", dict(fuse_rounds=False))):
        t0 = time.perf_counter()
        cpu_eng = TorchEngine(dic.n_resources, device="cpu", **caps, **kw)
        cpu_state = cpu_eng.materialise_state(facts, program)
        cpu_walls[label] = time.perf_counter() - t0
        same_result(f"full size: cuda vs cpu ({label})",
                    (cpu_eng.state_triples(cpu_state), cpu_eng.state_rep(cpu_state),
                     cpu_state.stats), card)
        del cpu_state
    cpu_wall = cpu_walls["fused"]
    print(f"  cuda == cpu at full size under both loops (cpu walls "
          f"{json.dumps(cpu_walls)} s)", flush=True)
    kg["rho"] = rho.numpy()
    out = dict(
        explicit_triples=int(facts.shape[0]), resources=int(dic.n_resources),
        wall_s=wall, repeat_wall_s=[r["wall_s"] for r in reruns],
        capture_s=graph.capture_s, replay_launches=graph.launches,
        rounds=stats.rounds, triples_total=stats.triples_total,
        triples_unmarked=stats.triples_unmarked, derivations=stats.derivations,
        rule_applications=stats.rule_applications,
        merged_resources=stats.merged_resources,
        capacity_restarts=stats.capacity_retries,
        caps=dict(capacity=eng.capacity, bind_cap=eng.bind_cap,
                  out_cap=eng.out_cap, rewrite_cap=eng.rewrite_cap),
        fused_first=first, fused_reruns=reruns, host_loop=host_runs,
        max_memory_allocated=first["max_memory_allocated"],
        max_memory_reserved=first["max_memory_reserved"],
        launches=launches, quiet_sweep=quiet, dedup_rows_s=dedup_rows_s,
        host_loop_with_dedup_rows_s=host_with_dedup_rows_s,
        numpy_host_rew_s=host_rew_s,
        cpu_wall_s=cpu_wall, cpu_host_loop_wall_s=cpu_walls["host_loop"],
    )
    print(f"  {json.dumps({k: v for k, v in out.items() if k not in ('fused_first', 'fused_reruns', 'host_loop')})}",
          flush=True)
    records["fullsize"] = out
    return launches


INC_MID_EVENTS = dict(n_events=6, batch=24, seed=0)
# the full-size update stream: change sets of 4,096 explicit triples, half
# deletes, 40 % of an add's rows fresh :idProp pairs that merge two cliques
INC_FULL_EVENTS = dict(n_events=8, batch=4096, p_delete=0.5, p_merge_add=0.4,
                       seed=0)
INC_HOST_LIMIT_S = 60.0  # a host-subsystem event longer than this ends its run


def _keys(rows: np.ndarray) -> np.ndarray:
    from repro_torch.core.triples import pack

    return np.sort(pack(np.asarray(rows, np.int32).reshape(-1, 3)))


def same_state(label: str, a, b) -> None:
    """Raise unless two engine states hold the same arrays, explicit set,
    program and counters (the wall aside)."""
    from repro_torch import TorchEngine
    from repro_torch.core.engine import state_to_arrays

    got, want = state_to_arrays(a), state_to_arrays(b)
    for k in got:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: {k} differs")
    if not np.array_equal(_keys(TorchEngine.explicit_rows(a)),
                          _keys(TorchEngine.explicit_rows(b))):
        raise AssertionError(f"{label}: explicit set differs")
    if a.program.rules != b.program.rules:
        raise AssertionError(f"{label}: program differs")
    same = {"wall_seconds": 0, "triples_unmarked": 0}
    if a.stats.as_dict() | same != b.stats.as_dict() | same:
        raise AssertionError(f"{label}: counters differ")


def same_store(label: str, rep, triples, want_rep, want_triples) -> None:
    """Raise unless two results hold the same rho and normal-form set."""
    if not np.array_equal(np.asarray(rep), np.asarray(want_rep)):
        raise AssertionError(f"{label}: rho differs")
    if not np.array_equal(_keys(triples), _keys(want_triples)):
        raise AssertionError(f"{label}: normal-form store differs")


def apply_event(eng, state, op: str, delta) -> None:
    (eng.add_facts if op == "add" else eng.delete_facts)(state, delta)


def incremental_midsize(records: dict) -> None:
    """Each mid-size profile's update stream under both loops, on the card
    and the CPU, equal after every event; the card's fused state equal to a
    from-scratch card run of the updated explicit set and to the numpy host
    subsystem (both: rho and the normal-form set)."""
    from repro_torch import TorchEngine
    from repro_torch.core import incremental
    from repro_torch.data.generator import PROFILES, generate, sample_update_stream

    out = {}
    for name in MIDSIZE:
        facts, program, dic = generate(**PROFILES[name])
        events = sample_update_stream(facts, dic, **INC_MID_EVENTS)
        n_res = dic.n_resources
        t0 = time.perf_counter()
        engines, states = {}, {}
        for label, device, fuse in (("cuda", "cuda", True), ("cpu", "cpu", True),
                                    ("cuda_host_loop", "cuda", False),
                                    ("cpu_host_loop", "cpu", False)):
            engines[label] = TorchEngine(n_res, device=device, fuse_rounds=fuse)
            states[label] = engines[label].materialise_state(facts, program)
        scratch = TorchEngine(n_res, device="cuda")
        host = incremental.materialise_incremental(facts, program, n_res,
                                                   use_kernel=True)
        walls = {k: [] for k in engines}
        for i, (op, delta) in enumerate(events):
            for label, eng in engines.items():
                ta = time.perf_counter()
                apply_event(eng, states[label], op, delta)
                walls[label].append(time.perf_counter() - ta)
            tag = f"{name} event {i} ({op})"
            same_state(f"{tag}: cuda vs cpu", states["cuda"], states["cpu"])
            same_state(f"{tag}: cuda vs cpu (host loop)", states["cuda_host_loop"],
                       states["cpu_host_loop"])
            card, eng = states["cuda"], engines["cuda"]
            rep, live = eng.state_rep(card), eng.state_triples(card)
            same_store(f"{tag}: fused vs host loop",
                       engines["cuda_host_loop"].state_rep(states["cuda_host_loop"]),
                       engines["cuda_host_loop"].state_triples(states["cuda_host_loop"]),
                       rep, live)
            scratch.n_resources = card.n_res
            slive, srep = scratch.materialise(TorchEngine.explicit_rows(card), program)[:2]
            same_store(f"{tag}: vs from scratch", rep, live, srep, slive)
            (incremental.add_facts if op == "add" else incremental.delete_facts)(host, delta)
            same_store(f"{tag}: vs host subsystem", rep, live, host.rep, host.triples())
        st = states["cuda"].stats
        counters = {k: getattr(st, k) for k in (
            "od_waves", "overdeleted", "suspects_split", "rederive_targeted",
            "remerge_targeted", "rounds", "capacity_retries", "triples_total")}
        out[name] = dict(counters, ops=[op for op, _ in events],
                         wall_s=time.perf_counter() - t0,
                         event_walls_s={k: v for k, v in walls.items()},
                         captures=engines["cuda"].captures)
        print(f"  {name}: {len(events)} events, cuda == cpu under both loops == "
              f"from scratch == host subsystem after each; {json.dumps(out[name])}",
              flush=True)
        del engines, states, scratch
        torch.cuda.empty_cache()
    records["incremental_midsize"] = out


def _event_split(split: dict, wall: float) -> dict:
    """Seconds of an update: its rolled-back attempts, then between the
    phase generator's yields in the last one: prepare (to "prepared", the
    snapshot included), seeded, waves, overdeleted, split, rederive,
    forward (to the end of the phases), and the barrier after them."""
    marks = split["phases"]
    out, last = {"retries": split["retries_s"]}, 0.0
    for label, t in marks:
        key = {"prepared": "prepare", "wave": "waves"}.get(label, label)
        out[key] = out.get(key, 0.0) + t - last
        last = t
    out["forward"] = split["attempt_s"] - last
    out["barrier"] = wall - split["retries_s"] - split["attempt_s"]
    return out


def _copy_state(eng, state):
    fresh = dataclasses.replace(state)
    eng._restore(fresh, eng._snapshot(state))
    return fresh


def incremental_fullsize(ops, records: dict, kg: dict, later: list) -> dict:
    """The OpenCyc-scale store under its update stream on the card: each
    event's wall, split, counters, launches and peak memory; each event's
    state equal to a from-scratch fused card run of the updated explicit set
    (rho and the normal-form set); the numpy host subsystem timed on the
    first add and the first delete.  Returns the launches of all events."""
    from repro_torch import TorchEngine
    from repro_torch.core import incremental
    from repro_torch.core.triples import TripleArena
    from repro_torch.data.generator import sample_update_stream

    facts, program = kg["facts"], kg["program"]
    dic = copy.copy(kg["dic"])  # the stream interns fresh ids: not into phase 8's
    dic._to_id, dic._to_name = dict(dic._to_id), list(dic._to_name)
    t0 = time.perf_counter()
    events = sample_update_stream(facts, dic, **INC_FULL_EVENTS)
    sample_s = time.perf_counter() - t0
    kg["update_stream"] = (dic, events)  # phase 5c serves the same stream
    print(f"  sampled {len(events)} events ({[op for op, _ in events]}, "
          f"{[int(d.shape[0]) for _, d in events]} rows) in {sample_s:.1f} s",
          flush=True)
    caps = dict(capacity=FULL_CAP, bind_cap=FULL_CAP, out_cap=FULL_CAP,
                rewrite_cap=FULL_CAP)
    eng = TorchEngine(FULL_RESOURCES, device="cuda", **caps)
    torch.cuda.empty_cache()
    state = eng.materialise_state(facts, program)
    torch.cuda.synchronize()
    base_state = _copy_state(eng, state)
    scratch = TorchEngine(FULL_RESOURCES, device="cuda", **caps)
    per_event, total = [], dict.fromkeys(ops.LAUNCHES, 0)
    for i, (op, delta) in enumerate(events):
        before = state.stats.as_dict()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ta = time.perf_counter()
        apply_event(eng, state, op, delta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ta
        launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        for k, n in launches.items():
            total[k] += n
        after = state.stats.as_dict()
        delta_of = {k: after[k] - before[k] for k in (
            "od_waves", "rounds", "overdeleted", "suspects_split",
            "rederive_targeted", "remerge_targeted", "capacity_retries")}
        rep, live = eng.state_rep(state), eng.state_triples(state)
        scratch.n_resources = state.n_res
        torch.cuda.synchronize()
        ts = time.perf_counter()
        sstate = scratch.materialise_state(TorchEngine.explicit_rows(state), program)
        torch.cuda.synchronize()
        scratch_s = time.perf_counter() - ts
        same_store(f"full size event {i} ({op}): vs from scratch", rep, live,
                   scratch.state_rep(sstate), scratch.state_triples(sstate))
        del sstate
        row = dict(op=op, rows=int(delta.shape[0]), wall_s=wall,
                   split=_event_split(eng.last_split, wall), **delta_of,
                   attempts=eng.last_split["attempts"],
                   captures=eng.last_split["captures"],
                   host_reads=eng.last_split["reads"], launches=launches,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   max_memory_reserved=torch.cuda.max_memory_reserved(),
                   from_scratch_wall_s=scratch_s, n_res=state.n_res,
                   triples_total=after["triples_total"])
        per_event.append(row)
        print(f"  event {i}: {json.dumps(row)}", flush=True)

    # the numpy host subsystem from the base state, event by event, until
    # the first add and the first delete are timed
    t0 = time.perf_counter()
    arena = TripleArena()
    arena.add_batch(eng.state_triples(base_state))
    host = incremental.IncrementalState(
        arena=arena, rep=eng.state_rep(base_state), program=base_state.program,
        base_program=program, explicit=TorchEngine.explicit_rows(base_state),
        n_resources=FULL_RESOURCES, device="cuda")
    host_setup_s = time.perf_counter() - t0
    host_walls, timed = [], set()
    for op, delta in events:
        if timed >= {"add", "delete"}:
            break
        ta = time.perf_counter()
        (incremental.add_facts if op == "add" else incremental.delete_facts)(host, delta)
        host_walls.append(dict(op=op, wall_s=time.perf_counter() - ta))
        timed.add(op)
        if host_walls[-1]["wall_s"] > INC_HOST_LIMIT_S:
            host_walls[-1]["stopped"] = True
            break
    print(f"  numpy host subsystem (set-up {host_setup_s:.2f} s): "
          f"{json.dumps(host_walls)}", flush=True)

    def profile_updates():
        """One add and one delete under torch.profiler, each from a copy of
        the base state (the copy is in the profiled span)."""
        out = {}
        first = {op: delta for op, delta in reversed(events)}
        for op in ("add", "delete"):
            prof, wall, _ = profiled(
                lambda op=op: apply_event(eng, _copy_state(eng, base_state), op,
                                          first[op]))
            out[op] = dict(profiled_wall_s=wall, device_time=device_time(prof, wall))
        print(f"  incremental, profiled add and delete: {json.dumps(out)}", flush=True)
        records["incremental_fullsize"]["profiled"] = out

    later.append(profile_updates)
    out = dict(events=per_event, sample_s=sample_s, host_setup_s=host_setup_s,
               host_subsystem=host_walls, launches=total,
               caps=dict(delta_out=eng.delta_out, delta_bind=eng.delta_bind,
                         delta_rewrite=eng.delta_rewrite),
               captures=eng.captures)
    records["incremental_fullsize"] = out
    print(f"  all events equal a from-scratch card run; launches of the 8 "
          f"events {json.dumps({k: n for k, n in total.items() if n})}", flush=True)
    del state, scratch
    torch.cuda.empty_cache()
    return total


SERVE_POINTS = 4096  # the idle drain's point lookups
SERVE_BURST = 256    # point queries admitted between two phases
SERVE_SAMPLE = 512   # batched answers held against the full host scalar path
SERVE_MIX = 512      # queries of the generator's §5 mix; those no wider than
SERVE_MIX_LIMIT_S = 15.0  # the matcher's width drained in chunks of 64 until
                          # a chunk ends past this much wall (their host
                          # clique expansion holds them: 25 ms a query)
SERVE_MID_EVENTS = dict(n_events=6, batch=24, p_query=0.5, seed=0)


def point_queries(facts: np.ndarray, n: int, seed: int) -> list:
    """A copy of ``benchmarks/bench_serve_updates.py``'s ``_point_queries``:
    (s,p,?), (s,?,?) and (?,p,o) lookups whose constants come from real
    triples with a subject out-degree or a (p,o) fan-in of at most 32."""
    from repro_torch.sparql import Query

    rng = np.random.default_rng(seed)
    key_po = facts[:, 1].astype(np.int64) << 32 | facts[:, 2].astype(np.int64)
    _, inv, cnt = np.unique(key_po, return_inverse=True, return_counts=True)
    _, inv_s, cnt_s = np.unique(facts[:, 0], return_inverse=True,
                                return_counts=True)
    sel_po = np.flatnonzero(cnt[inv] <= 32)
    sel_s = np.flatnonzero(cnt_s[inv_s] <= 32)
    out = []
    for _ in range(n):
        kind = int(rng.integers(3))
        pool = sel_po if kind == 2 else sel_s
        if pool.shape[0] == 0:
            pool = np.arange(facts.shape[0])
        s, p, o = (int(t) for t in facts[pool[rng.integers(pool.shape[0])]])
        if kind == 0:
            q = Query([(s, p, -1)], [], [-1], False)
        elif kind == 1:
            q = Query([(s, -1, -2)], [], [-1, -2], False)
        else:
            q = Query([(-1, p, o)], [], [-1], False)
        out.append(q)
    return out


def point_kind(q) -> int:
    """0 for (s,p,?), 1 for (s,?,?), 2 for (?,p,o)."""
    s, p, _o = q.patterns[0]
    return 2 if s < 0 else (1 if p < 0 else 0)


class PointOracle:
    """The scalar host path on the rows a point query can match: a
    published snapshot's host triples indexed by subject and by (p,o).
    ``answer(q)`` is ``evaluate`` on the query's slice, which equals
    ``evaluate`` on every row for a one-atom query whose subject, or whose
    (p,o), is a constant (checked against ``evaluate_at`` on a sample)."""

    def __init__(self, snap) -> None:
        t = snap.triples
        self.snap = snap
        self.answers: dict = {}
        self.s_order = np.argsort(t[:, 0], kind="stable")
        self.s_sorted = t[self.s_order, 0].astype(np.int64)
        po = t[:, 1].astype(np.int64) << 21 | t[:, 2]
        self.po_order = np.argsort(po, kind="stable")
        self.po_sorted = po[self.po_order]

    def answer(self, q, dic):
        """The answer of ``q``, kept for the same query object."""
        key = id(q)
        if key not in self.answers:
            self.answers[key] = (q, self._answer(q, dic))
        return self.answers[key][1]

    def _answer(self, q, dic):
        from repro_torch.sparql import evaluate
        from repro_torch.sparql.executor import _normalise_query

        (s, p, o), = _normalise_query(q, self.snap.rho.rep).patterns
        if s >= 0:
            order, keys, key = self.s_order, self.s_sorted, s
        else:
            order, keys, key = self.po_order, self.po_sorted, p << 21 | o
        key = np.int64(key)  # keys' own type: no copy of the keys a search
        lo, hi = np.searchsorted(keys, key, "left"), np.searchsorted(keys, key, "right")
        rows = self.snap.triples[np.sort(order[lo:hi])]
        return evaluate(q, rows, self.snap.rho, dic)


def ms_stats(seconds: list) -> dict:
    a = np.asarray(seconds, np.float64) * 1e3
    if a.size == 0:
        return dict(n=0)
    return dict(n=int(a.size), mean=float(a.mean()), p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)))


def wider_than(bx, queries: list, snap) -> np.ndarray:
    """Per query, True where the batched matcher flags an answer wider than
    its width (the store would answer it on the host) or finds no plan.
    At OpenCyc scale the §5 mix's scans and joins on a hub predicate or
    object are such queries, and their host answers (a join's bag grows
    with the square of a hub's fan-in) take minutes each."""
    from repro_torch.core.terms import is_var
    from repro_torch.sparql import batched
    from repro_torch.sparql.executor import _normalise_query

    groups: dict = {}
    for i, q in enumerate(queries):
        qn = _normalise_query(q, snap.rho.rep)
        sig, _ = batched.shape_signature(qn.patterns)
        groups.setdefault(sig, []).append((i, qn))
    wide = np.zeros(len(queries), dtype=bool)
    views = snap.device_views()
    for sig, items in groups.items():
        plan = batched.build_plan(sig)
        idx = [i for i, _ in items]
        if plan is None:
            wide[idx] = True
            continue
        consts = torch.tensor([[t for atom in qn.patterns for t in atom if not is_var(t)]
                               for _, qn in items], dtype=torch.int32, device=views[1].device)
        _, _, overflow = batched._bgp(plan.probes, plan.var_order, bx.width, *views,
                                      consts)
        wide[idx] = overflow.cpu().numpy()
    return wide


def record_publications(store) -> list:
    """Every snapshot the store publishes from now on, its construction's
    first."""
    snaps = [store.snapshot]
    inner = store._publish

    def publish():
        snap = inner()
        snaps.append(snap)
        return snap

    store._publish = publish
    return snaps


def same_snapshot(label: str, a, b) -> None:
    """Raise unless two published snapshots hold the same four arrays (on
    any device), n_live, epoch and rho."""
    if (a.epoch, a.n_live) != (b.epoch, b.n_live):
        raise AssertionError(f"{label}: epoch or n_live differs")
    for k in ("d_triples", "d_keys", "d_triples_pos", "d_keys_pos"):
        x, y = getattr(a, k), getattr(b, k)
        if not torch.equal(x, y.to(x.device)):
            raise AssertionError(f"{label}: {k} differs")
    if not np.array_equal(a.rho.rep, b.rho.rep):
        raise AssertionError(f"{label}: rho differs")


def serving_midsize(records: dict) -> None:
    """Each mid-size profile's mixed trace (``sample_update_stream`` with
    query events, four point lookups after each event) through a store on the card
    and one on the CPU under the cooperative scheduler and one tick
    pattern: the same answers and epochs, every published snapshot bit for
    bit; then a threaded store on the card, each answer equal to the CPU
    store's at its epoch and each snapshot to the CPU's of the same epoch."""
    from repro_torch.data.generator import PROFILES, generate, sample_update_stream
    from repro_torch.serve import TripleStore
    from repro_torch.sparql import evaluate_at

    out = {}
    for name in MIDSIZE:
        t0 = time.perf_counter()
        facts, program, dic = generate(**PROFILES[name])
        points = point_queries(facts, 64, 1)
        trace = []  # four point lookups after each event of the mixed trace
        for i, ev in enumerate(sample_update_stream(facts, dic, **SERVE_MID_EVENTS)):
            trace += [ev] + [("query", q) for q in points[4 * i:4 * i + 4]]
        stores = {d: TripleStore(facts, program, dic, device=d) for d in ("cuda", "cpu")}
        pubs = {d: record_publications(s) for d, s in stores.items()}
        tickets = {d: [] for d in stores}
        rng = np.random.default_rng(0)
        for op, payload in trace:
            for d, store in stores.items():
                if op == "query":
                    tickets[d].append(store.submit_query(payload))
                else:
                    store.submit_update(op, payload)
            for _ in range(int(rng.integers(0, 3))):
                for store in stores.values():
                    store.step()
        for store in stores.values():
            store.drain()
        for a, b in zip(tickets["cuda"], tickets["cpu"]):
            if (a.epoch, a.answer) != (b.epoch, b.answer):
                raise AssertionError(f"{name}: query {a.uid} differs on the card")
        if len(pubs["cuda"]) != len(pubs["cpu"]):
            raise AssertionError(f"{name}: publications differ")
        for a, b in zip(pubs["cuda"], pubs["cpu"]):
            same_snapshot(f"{name} epoch {a.epoch} card vs cpu", a, b)
        cpu_at = {s.epoch: s for s in pubs["cpu"]}
        threaded = TripleStore(facts, program, dic, device="cuda", threaded=True)
        tpub = record_publications(threaded)
        answered = []
        try:
            for op, payload in trace:
                if op == "query":
                    answered.append(threaded.submit_query(payload))
                else:
                    threaded.submit_update(op, payload)
                if rng.random() < 0.6:
                    threaded._drain_queries()
            while threaded.pending():  # reads while the worker runs
                answered.append(threaded.query_now(points[len(answered) % 64]))
            threaded.drain()
        finally:
            threaded.close()
        for t in answered:
            if t.answer != evaluate_at(t.query, cpu_at[t.epoch], dic)[0]:
                raise AssertionError(f"{name}: threaded query {t.uid} differs")
        for a in tpub:
            same_snapshot(f"{name} threaded epoch {a.epoch}", a, cpu_at[a.epoch])
        out[name] = dict(
            events=[op for op, _ in trace], queries=len(tickets["cuda"]),
            epochs=stores["cuda"].epoch, batched=stores["cuda"]._batched.stats,
            threaded_epochs_read=sorted({t.epoch for t in answered}),
            wall_s=time.perf_counter() - t0)
        print(f"  {name}: card == cpu (answers, epochs, {len(pubs['cpu'])} snapshots "
              f"bit for bit), threaded card == cpu at each epoch; "
              f"{json.dumps(out[name])}", flush=True)
        del stores, threaded
        torch.cuda.empty_cache()
    records["serving_midsize"] = out


def serving_fullsize(ops, records: dict, kg: dict, later: list) -> dict:
    """The serving tier at OpenCyc scale (phase 5's facts, caps 2^22):
    (a) idle: 4,096 point lookups drained in shape groups, then in bursts
    of 256 for per-query latency; a seeded sample of 512 against the full
    host scalar path (timed: the scalar drain); the generator's §5 mix of
    512: those no wider than the matcher's width drained in chunks against
    the scalar path until a chunk ends past 15 s (the wider ones counted:
    their host answers take minutes);
    (b) busy: phase 5b's 8 change sets through the cooperative scheduler,
    a burst of 256 point lookups after every phase step, each answer held
    against the scalar path at its epoch; the final snapshot against a
    from-scratch card run; (c) threaded: the same stream on a threaded
    store while this thread drains bursts ending in ``query_now``, each
    answer and snapshot held against (b)'s at the same epoch.  Returns the
    launches of (a)-(b) by kernel."""
    from repro_torch import TorchEngine
    from repro_torch.data.generator import sample_update_stream
    from repro_torch.serve import TripleStore
    from repro_torch.sparql import evaluate_at

    facts, program = kg["facts"], kg["program"]
    dic, events = kg["update_stream"]
    caps = dict(capacity=FULL_CAP, bind_cap=FULL_CAP, out_cap=FULL_CAP,
                rewrite_cap=FULL_CAP)
    t0 = time.perf_counter()
    points = point_queries(facts, SERVE_POINTS, 2)
    mix = [q for _, q in sample_update_stream(facts, dic, n_events=SERVE_MIX,
                                              p_query=1.0, seed=1)]
    out: dict = dict(queries_s=time.perf_counter() - t0)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    store = TripleStore(facts, program, dic,
                        engine=TorchEngine(FULL_RESOURCES, device="cuda", **caps))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    snaps = record_publications(store)
    snap0, bx = store.snapshot, store._batched

    # (a) idle
    drains = []
    for _ in range(2):  # the first drain grows the allocator's pools
        tk = [store.submit_query(q) for q in points]
        ta = time.perf_counter()
        store.drain()
        drains.append(time.perf_counter() - ta)
    if any(t.epoch != 0 or t.status != "done" for t in tk):
        raise AssertionError("idle drain: a query not answered at epoch 0")
    idle = []
    for at in range(0, SERVE_POINTS, SERVE_BURST):
        burst = [store.submit_query(q) for q in points[at:at + SERVE_BURST]]
        store._drain_queries()
        idle += [t.wall_s for t in burst]
    rng = np.random.default_rng(3)
    sample = sorted(rng.choice(SERVE_POINTS, SERVE_SAMPLE, replace=False).tolist())
    kinds = {point_kind(points[i]) for i in sample}
    if kinds != {0, 1, 2}:
        raise AssertionError(f"the sample holds shapes {kinds}, want all three")
    squeries = [points[i] for i in sample]
    ta = time.perf_counter()
    scalar = [evaluate_at(q, snap0, dic) for q in squeries]
    scalar_s = time.perf_counter() - ta
    ta = time.perf_counter()
    batched = bx.run(squeries, snap0, dic)
    batched_s = time.perf_counter() - ta
    oracle0 = PointOracle(snap0)
    for i, q, want, got in zip(sample, squeries, scalar, batched):
        if got != want or tk[i].answer != want[0]:
            raise AssertionError(f"point query {i}: batched != scalar at epoch 0")
        if oracle0.answer(q, dic) != want[0]:
            raise AssertionError(f"point query {i}: the sliced oracle != scalar")
    stats0 = dict(bx.stats)
    wide = wider_than(bx, mix, snap0)
    narrow = [q for q, w in zip(mix, wide) if not w]
    mix_done, mix_s, mix_scalar_s = 0, 0.0, 0.0
    while mix_done < len(narrow) and mix_s + mix_scalar_s < SERVE_MIX_LIMIT_S:
        chunk = narrow[mix_done:mix_done + 64]
        ta = time.perf_counter()
        got = bx.run(chunk, snap0, dic)
        mix_s += time.perf_counter() - ta
        ta = time.perf_counter()
        want = [evaluate_at(q, snap0, dic) for q in chunk]
        mix_scalar_s += time.perf_counter() - ta
        if got != want:
            raise AssertionError(f"the mix from query {mix_done}: batched != scalar")
        mix_done += len(chunk)
    out["idle"] = dict(
        drain_s=drains, drain_qps=SERVE_POINTS / drains[-1],
        per_query_ms=ms_stats(idle),
        sample=dict(n=SERVE_SAMPLE, batched_s=batched_s, scalar_s=scalar_s,
                    batched_qps=SERVE_SAMPLE / batched_s,
                    scalar_qps=SERVE_SAMPLE / scalar_s,
                    speedup=scalar_s / batched_s),
        mix=dict(n=len(mix), wider_than_w=int(wide.sum()), drained=mix_done,
                 batched_s=mix_s, scalar_s=mix_scalar_s,
                 stats={k: bx.stats[k] - stats0[k] for k in bx.stats}),
        stats=dict(bx.stats))
    print(f"  idle: {json.dumps(out['idle'])}", flush=True)

    # (b) busy, cooperative
    oracles = {0: oracle0}
    busy, per_event, qi = [], [], 0
    for i, (op, delta) in enumerate(events):
        t = store.submit_update(op, delta)
        steps, bursts = [], []
        while t.status != "done":
            torch.cuda.synchronize()
            ta = time.perf_counter()
            store.step()
            torch.cuda.synchronize()
            steps.append((store.inflight_phase or "barrier",
                          time.perf_counter() - ta))
            qs = [points[(qi + k) % SERVE_POINTS] for k in range(SERVE_BURST)]
            qi += SERVE_BURST
            burst = [store.submit_query(q) for q in qs]
            ta = time.perf_counter()
            store._drain_queries()
            bursts.append(time.perf_counter() - ta)
            busy += burst
        oracles[store.epoch] = PointOracle(store.snapshot)
        row = dict(op=op, rows=int(delta.shape[0]), epoch=t.epoch, wall_s=t.wall_s,
                   steps=steps, burst_s=bursts, publish_ms=t.publish_ms,
                   publish_split=store.publish_split[-1])
        per_event.append(row)
        print(f"  event {i}: {json.dumps(row)}", flush=True)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    ta = time.perf_counter()
    for t in busy:
        if t.answer != oracles[t.epoch].answer(t.query, dic):
            raise AssertionError(f"busy query {t.uid}: != scalar at epoch {t.epoch}")
    check_s = time.perf_counter() - ta
    state = store.state
    scratch = TorchEngine(state.n_res, device="cuda", **caps)
    sstate = scratch.materialise_state(TorchEngine.explicit_rows(state), program)
    final = store.snapshot
    same_store("serving, final snapshot vs from scratch", final.rho.rep,
               final.triples, scratch.state_rep(sstate), scratch.state_triples(sstate))
    del sstate, scratch
    dc = store.dispatch_counts
    idle_p50 = out["idle"]["per_query_ms"]["p50"]
    out["busy"] = dict(
        events=per_event, per_query_ms=ms_stats([t.wall_s for t in busy]),
        epochs_read=sorted({t.epoch for t in busy}), check_s=check_s,
        publish_ms=store.publish_ms, publish_split=store.publish_split,
        stats=dict(bx.stats))
    out["busy_over_idle"] = out["busy"]["per_query_ms"]["p50"] / idle_p50
    out["launches"] = launches
    out["dispatch_counts"] = dc
    out["drain_launches"] = {k.split("/")[1]: n for k, n in dc["by_phase"].items()
                             if k.startswith("query/")}
    out["publish_launches"] = {k.split("/")[1]: n for k, n in dc["by_phase"].items()
                               if k.startswith("publish/")}
    for phase, want in (("drain", "prefix_range_bounds"), ("publish", "dedup_order")):
        if not out[f"{phase}_launches"].get(want):
            raise AssertionError(f"the {phase} launched no {want}")
    missing = [k for k in REW_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"the served updates launched no {missing}")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    print(f"  busy: {len(busy)} answers right at epochs {out['busy']['epochs_read']}; "
          f"per query {json.dumps(out['busy']['per_query_ms'])}, busy/idle "
          f"{out['busy_over_idle']:.3f}; final snapshot == from scratch; "
          f"publish ms {[round(x, 2) for x in store.publish_ms]}; drain launches "
          f"{json.dumps(out['drain_launches'])}, publish launches "
          f"{json.dumps(out['publish_launches'])}; peak memory "
          f"{out['max_memory_allocated'] / 1e9:.2f} GB allocated, "
          f"{out['max_memory_reserved'] / 1e9:.2f} GB reserved", flush=True)
    coop = {s.epoch: s for s in snaps}
    del store
    torch.cuda.empty_cache()

    # (c) threaded, with reads on this thread while the worker runs
    ta = time.perf_counter()
    threaded = TripleStore(facts, program, dic, threaded=True,
                           engine=TorchEngine(FULL_RESOURCES, device="cuda", **caps))
    build_s = time.perf_counter() - ta
    tsnaps = record_publications(threaded)
    answered, reads_busy = [], 0
    try:
        ta = time.perf_counter()
        for op, delta in events:
            threaded.submit_update(op, delta)
        while threaded.pending():
            qs = [points[(qi + k) % SERVE_POINTS] for k in range(SERVE_BURST)]
            qi += SERVE_BURST
            burst = [threaded.submit_query(q) for q in qs[:-1]]
            burst.append(threaded.query_now(qs[-1]))
            answered += burst
            reads_busy += 1
        threaded.drain()
        wall = time.perf_counter() - ta
        captures = dict(threaded.engine.captures_by_family)
    finally:
        threaded.close()
    for t in answered:
        if t.answer != oracles[t.epoch].answer(t.query, dic):
            raise AssertionError(f"threaded query {t.uid}: != scalar at epoch {t.epoch}")
    for s in tsnaps:
        same_snapshot(f"threaded epoch {s.epoch} vs cooperative", s, coop[s.epoch])
    out["threaded"] = dict(
        build_s=build_s, wall_s=wall, bursts=reads_busy, answers=len(answered),
        epochs_read=sorted({t.epoch for t in answered}), captures=captures,
        per_query_ms=ms_stats([t.wall_s for t in answered]),
        publish_ms=threaded.publish_ms)
    print(f"  threaded: {json.dumps(out['threaded'])}", flush=True)
    del threaded, tsnaps, coop, snaps, oracles
    torch.cuda.empty_cache()

    def profile_drain():
        """The idle drain of the 4,096 point lookups under torch.profiler
        (the final snapshot)."""
        prof, wall, _ = profiled(lambda: bx.run(points, final, dic))
        res = dict(profiled_wall_s=wall, device_time=device_time(prof, wall))
        records["serving_fullsize"]["profiled_drain"] = res
        print(f"  serving, profiled drain of {SERVE_POINTS} lookups: "
              f"{json.dumps(res)}", flush=True)

    later.append(profile_drain)
    records["serving_fullsize"] = out
    return launches


def search_census(ops, run) -> dict:
    """``run()`` (one REW materialisation) under torch.profiler with every
    search call classified: its form (both sides, left, right, prefix of
    k), whether its queries came sorted, and the size class (2^ceil(log2))
    of its n queries and v keys; per class the calls and the search
    kernel's device time.  The i-th search kernel of the trace is the i-th
    call that launched one (n > 0); were the two counts to differ, the
    calls would be counted and not timed."""
    calls: list = []
    search, prefix = ops._search, ops.prefix_range_bounds

    def census_search(queries, keys, lo, hi):
        form = "both" if lo and hi else "left" if lo else "right"
        calls.append((form, queries.shape[0], keys.shape[0],
                      (queries[1:] >= queries[:-1]).all()))
        return search(queries, keys, lo, hi)

    def census_prefix(prefix_cols, keys):
        k = prefix_cols.shape[1]
        packed = prefix_cols[:, 0].to(torch.int64)
        for j in range(1, k):
            packed = (packed << 21) | prefix_cols[:, j]
        calls.append((f"prefix k={k}", prefix_cols.shape[0], keys.shape[0],
                      (packed[1:] >= packed[:-1]).all()))
        return prefix(prefix_cols, keys)

    def once():
        calls.clear()
        return run()

    ops._search, ops.prefix_range_bounds = census_search, census_prefix
    try:
        prof, _, _ = profiled(once)
    finally:
        ops._search, ops.prefix_range_bounds = search, prefix
    launched = [c for c in calls if c[1] > 0]
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and kernel_of(e.name) == "search_bounds"),
                     key=lambda e: e.time_range.start)
    matched = len(kernels) == len(launched)  # else the calls are counted, not timed
    flags = torch.stack([c[3] for c in launched]).tolist() if launched else []
    out: dict = {}
    for i, ((form, n, v, _), srt) in enumerate(zip(launched, flags)):
        key = (f"{form}, {'sorted' if srt else 'unsorted'}, n 2^{log2c(n)}, "
               f"v 2^{log2c(v)}")
        entry = out.setdefault(key, dict(calls=0, device_ms=0.0 if matched else None))
        entry["calls"] += 1
        if matched:
            entry["device_ms"] += kernels[i].time_range.elapsed_us() / 1e3
    out = dict(sorted(out.items(), key=lambda kv: (-(kv[1]["device_ms"] or 0),
                                                   -kv[1]["calls"])))
    return dict(classes=out, calls=len(launched), kernels_in_trace=len(kernels),
                device_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3)


# device kernel names of each port kernel (csrc/*.cu)
KERNEL_OF = {
    "radix_histogram": "dedup_order", "radix_plan": "dedup_order",
    "radix_pass": "dedup_order",
    "search_tile_kernel": "search_bounds", "rewrite_kernel": "rewrite_triples",
    "halve_kernel": "uf_compress", "finish_kernel": "uf_compress",
    "union_kernel": "uf_union",
    "flash_kernel": "flash_attention", "flash_wgmma_kernel": "flash_attention",
    "fm_slab_kernel": "fm_interact", "fm_row_kernel": "fm_interact",
    "seg_wide_kernel": "segment_sum", "seg_narrow_kernel": "segment_sum",
    "seg_fix_kernel": "segment_sum",
    "bag_narrow_kernel": "embedding_bag", "bag_wide_kernel": "embedding_bag",
}


def kernel_of(name: str) -> str | None:
    """The port kernel whose device function ``name`` is, else None."""
    return next((k for n, k in KERNEL_OF.items() if n in name), None)


def device_time(prof, wall_s: float) -> dict:
    """Device time of the profiled run: per port kernel, the rest of
    PyTorch's kernels (glue) by name, and the busy share of the wall time."""
    by_kernel: dict = {}
    glue: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue  # host-side events and the profiler's step annotation
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        port = kernel_of(e.key)
        bucket, key = (by_kernel, port) if port else (glue, e.key[:80])
        bucket[key] = bucket.get(key, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values()) + sum(glue.values())
    top_glue = dict(sorted(glue.items(), key=lambda kv: -kv[1])[:12])
    return dict(busy_ms=busy_ms, busy_share=busy_ms / 1e3 / wall_s,
                port_kernels_ms=by_kernel, glue_ms_total=sum(glue.values()),
                glue_top_ms=top_glue)


SOURCES = {  # kernel -> (source, TPU kernel it replaces)
    "dedup_order": ("dedup_order.cu", "src/repro/kernels/dedup.py:94"),
    "search_bounds": ("search_bounds.cu", "src/repro/kernels/bsearch.py:49"),
    "rewrite_triples": ("rewrite_triples.cu",
                        "src/repro/kernels/rewrite_triples.py:45"),
    "uf_compress": ("union_find.cu", "src/repro/kernels/pointer_jump.py:47"),
    "uf_union": ("union_find.cu", "src/repro/kernels/pointer_jump.py:47"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:90"),
    "fm_interact": ("fm_interact.cu", "src/repro/kernels/fm_interact.py:27"),
    "segment_sum": ("segment_sum.cu", "src/repro/kernels/segment_sum.py:43"),
    "embedding_bag": ("embedding_bag.cu", "src/repro/kernels/embedding_bag.py:44"),
}


def rew_kernel_times(src: Path) -> dict:
    """``--rew-kernels``: the rewrite in both forms (rows as phase 3's) and
    ``merge_pairs`` on phase 3's main and stress cases, of the port under
    ``src``: medians of 20 single calls by CUDA events, then the device
    time a call (all its kernels, torch.profiler), the launches of one
    merge, and a digest of every result."""
    sys.path.insert(0, str(src))
    from repro_torch.core.uf import merge_pairs
    from repro_torch.kernels import ops

    dev, digest, calls, out = "cuda", hashlib.sha256(), [], {"src": str(src)}
    for n, form, seed in ((1 << 22, "normalise", 4), (FULL_CAP + 1, "sweep", 5)):
        spo, rho, kw = rewrite_inputs(n, form, seed, dev)
        for t in ops.rewrite_triples(spo, rho, **kw):
            digest.update(t.cpu().numpy().tobytes())
        calls.append((f"rewrite_{form}", functools.partial(
            ops.rewrite_triples, spo, rho, **kw)))
    for main, seed, case in ((True, 6, "main"), (False, 7, "stress")):
        V, _, buf, pv = union_inputs(main, seed, dev)
        base = torch.arange(V, dtype=torch.int32, device=dev)
        before = dict(ops.LAUNCHES)
        digest.update(merge_pairs(base, buf, pv).cpu().numpy().tobytes())
        out[f"merge_{case}_launches"] = {
            k: c - before[k] for k, c in ops.LAUNCHES.items() if c != before[k]}
        calls.append((f"merge_{case}", functools.partial(merge_pairs, base, buf, pv)))
    for name, fn in calls:  # every event time before the first profile
        out[f"{name}_ms"] = time_ms(fn, reps=20)
    for name, fn in calls:
        out[f"{name}_device_ms"] = device_ms_per_call(fn, calls=20)
    out["digest"] = digest.hexdigest()[:16]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if "--rew-kernels" in sys.argv[1:]:
        args = sys.argv[1:]
        src = Path(args[args.index("--src") + 1]) if "--src" in args else ROOT / "src"
        print(card_line(), flush=True)
        print(json.dumps(rew_kernel_times(src.resolve())), flush=True)
        return
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops, ref

    card = card_line()
    print(card, flush=True)
    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    records: dict = {"card": card, "torch": torch.__version__,
                     "cuda": torch.version.cuda}
    print("build:", flush=True)
    built = _build.build_all(verbose=True)
    # each device function's registers and spills, by ptxas
    records["ptxas"] = {}
    for name, text in built["ptxas"].items():
        lines = [line.split(":", 1)[-1].strip() for line in text.splitlines()
                 if "Compiling entry" in line or "Used" in line or "spill" in line]
        records["ptxas"][name] = lines
        for line in lines:
            print(f"  {name}: {line}")
    print(f"  built {built['built']} in {built['seconds']:.1f} s", flush=True)
    records["build_s"] = built["seconds"]

    t_start = time.perf_counter()

    records["phase_start_s"] = {}

    def phase(title: str) -> None:
        at = time.perf_counter() - t_start
        records["phase_start_s"][title.rstrip(":")] = at
        print(f"{title} [{at:.0f} s]", flush=True)

    # torch.profiler work waits until every wall and event time is taken:
    # a finished profiler session leaves host cost on every later launch
    # (phase 6 times its traffic again after all of it, for the record)
    later: list = []
    phase("kernels (kernel == plain version on the card):")
    kernel_records: dict = {}
    kg = full_kg()
    kernel_phase(ops, ref, kernel_records, "cuda")
    search_kernel_phase(ops, ref, kernel_records, "cuda")
    rew_kernel_phase(ops, ref, kernel_records, "cuda", later)
    serving_kernel_phase(ops, ref, kernel_records, "cuda", later)
    segment_bag_kernel_phase(ops, ref, kernel_records,
                             kg["facts"][:, 2].astype(np.int32), "cuda", later)
    records["kernels"] = kernel_records

    phase("mid-size (both loops, cuda == cpu; Theorem 1 against the host AX):")
    midsize_phase(records)

    phase("REW at full size (main path):")
    launches = fullsize_phase(ops, records, kg, later)

    phase("incremental maintenance (add/delete), card == CPU == from scratch:")
    incremental_midsize(records)
    incremental_fullsize(ops, records, kg, later)

    phase("the serving tier (SPARQL over epoch snapshots), card == CPU == scalar:")
    serving_midsize(records)
    serving_fullsize(ops, records, kg, later)
    del kg["update_stream"]

    phase("LM serving at full width (SmolLM-135M, flash):")
    launches["flash_attention"] = lm_serving_phase(ops, records, later)

    phase("FM serving at full scale (Criteo-scale FM, rho):")
    fm_launches = fm_serving_phase(ops, records, later)
    for name in ("fm_interact", "embedding_bag"):
        launches[name] = fm_launches[name]

    phase("GNN inference on the sameAs-deduplicated KG (GatedGCN, PNA):")
    launches["segment_sum"] = gnn_phase(ops, records, kg)

    phase("device times under torch.profiler (kernels, REW, updates, LM and FM serving):")
    for job in later:
        job()

    phase("done:")
    line = []
    for name, (source, replaces) in SOURCES.items():
        r = next(e for e in kernel_records[name] if e["main_path"])
        line.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}", replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    records["profiler_lost"] = PROFILER_LOST
    (out_dir / "chip_smoke.json").write_text(json.dumps(records, indent=1))
    print(card_line())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
