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
   against the port's host AX materialisation (``check_theorem1``); the
   paper's factor rows (``factor_over``: AX over REW) for each profile;
5. REW at full size: ``opencyc_like`` at OpenCyc's scale (2.4 M explicit
   triples, 361,200 merged resources) materialised on the card through
   :class:`repro_torch.TorchEngine`, built by ``TorchEngine.from_config``
   from the ``sameas_rew`` config with phase 5's caps (2^22; phases 5b and
   5c build theirs so too): three runs of the host loop, then the
   default engine's first run (round 1 eager, the capture of the round
   graph, one replay and one host read a round; its wall time is the
   end-to-end number and its launches the main path's) and three reruns
   that replay the graph from round 1; each run's wall split (set-up, each
   round's wall, wait and reads, stats) and peak memory (allocated and
   reserved, the graph's pool included), and its dispatches by family
   (``engine.dispatches``); the first run's ``dedup_order`` launches by
   key count (the eager ones and those recorded at the graph's capture
   times its replays).  Structural checks of the result;
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
   wall is printed beside); the engine's dispatches reconciled with the
   static phase profile (``dispatch_crosscheck``); the numpy host
   subsystem timed on the first add and the first delete (stopped after an
   event of more than 60 s).  At the end, one add and one delete profiled;
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
   launches and dispatches by phase, both stores' ``audit()`` empty, peak
   memory, and at the end a profiled drain;
5d. the audit: ``repro_torch.analysis.run_report`` on the card at the
   probe geometry of each of the reference's four probe datasets (every
   registered unit recorded once, with its kernel launches; the four
   passes; a driven delete and add reconciled with the static profile):
   no violation outside the recorded list (empty) and no dispatch problem;
   the launch records hold every REW kernel; then the dispatch
   cross-checks of phases 5, 5b and 5c, all empty;
6. LM serving at full width: SmolLM-135M (random weights from seed 0) with
   the flash kernel behind ``ServeEngine`` (16 slots, 1024 rows) answers 64
   requests of 32-512 prompt tokens and 32 new tokens; wall, tokens per
   second, peak memory; the card's teacher-forced logits of two requests
   equal the CPU's within a stated tolerance; at the end a profiled rerun
   for the device's and the flash kernel's share;
6b. MoE serving at full width: (a) DeepSeek-MoE-16B whole (28 layers, 64
   routed experts top-6, 2 shared; random weights from seed 0, a seeded
   non-zero router) behind phase 6's ``ServeEngine`` answers phase 6's 64
   requests: wall, tokens per second, prefill and decode split, the decode
   step beside its bound (every weight read once a step), peak memory, the
   arena, ``flash_attention`` launched 64 x 28 times; the traffic again
   under a routing log (the expert load, the share of (token, k) pairs
   that capacity dropped) with the same tokens, and its first wave alone
   with bit-equal logits; (b) Qwen3-MoE-235B at full width, its depth cut
   to 4 of 94 layers: one prefill of 512 tokens and 16 decode steps.  For
   each, the model cut to 2 (DeepSeek) or 1 (Qwen3) layers on the card
   against the CPU: the teacher-forced logits of the shortest request and
   the one nearest 128 prompt tokens, each MoE call's top k compared (a
   flip only at a near tie, within 1e-3), logits within a stated tolerance
   before the first flip and everywhere against the CPU replaying the
   card's routing; at the end a profiled rerun of (a)'s first wave;
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
   a GatedGCN forward, and two card runs bit-equal;
9. the sharded engine (``TorchEngine(mesh=...)`` on ``torch.distributed``,
   one spawned process a rank; the kernels built above): (a) phase 4's
   profiles at mid size, at world 1 on NCCL and world 2 on the one card
   through gloo, each with a loop and exchange (fused or host loop,
   gathered or routed at ``route_cap`` 256) and 4 events of
   ``sample_update_stream``: each rank's arrays, rho and counters on the
   card equal the CPU's through a mesh of the same size, and the gathered
   store and rho the unsharded card engine's, after every step; (b) phase
   5's facts at world 1 on NCCL and (c) at world 2 through gloo (which
   carries the CUDA tensors itself), owner-routed (``route_cap`` 2^25 at
   world 1, 2^24 above: what a full-size round needs), phase 5's caps:
   the first run and two reruns, each rank's wall, rounds, launches by
   kernel (every REW kernel launched), collective calls and bytes, and
   peak memory; after every run the gathered store, rho and counters
   equal phase 5's unsharded fused run's, whose rerun walls are recorded
   beside.  Where the machine has
   more cards, full size at world = their count on NCCL too;
10. training on the card, through ``repro_torch.train.Trainer`` and
   AdamW: (a) the main path: GatedGCN at full width (16 layers, d_hidden
   70, 40 classes, d_in 16) on minibatches that ``NeighborSampler`` draws
   at ``minibatch_lg``'s geometry (1,024 seeds, fanout 15 then 10: 169,984
   nodes and 168,960 edges) from phase 8's deduplicated KG made
   undirected and cut to its nodes with an edge, seeds drawn by the step;
   the loss on the seeds; 40 steps (checkpoints every 10, the async
   writer): each step's wall, steps/s, edges/s, peak memory, the launches
   a step (forward and backward) held to exact counts; a run killed after
   step 17 and resumed gives bit-identical losses, parameters and moments;
   the segment sum against its plain version at the shapes training
   gives it; the card against the CPU on three batches at 2 layers; (b)
   EGNN and DimeNet at their configs on the ``molecule`` shape (128 graphs
   of 30 nodes and 64 edges; DimeNet's 32,768 triplets), GatedGCN and PNA
   at full config on ``full_graph_sm``: the first step's loss and
   gradients against the CPU, 5 steps twice (finite losses, moved
   parameters, the two runs bit-equal; PNA's equality recorded); (c)
   SmolLM-135M at full width, 5 steps of ``lm_batch`` at 4 x 1,024
   tokens, remat on, and (d) the Criteo-scale FM, 5 steps of
   ``recsys_batch`` at 65,536 rows, each twice: step walls, peak memory,
   whether the two runs are bit-equal; (e) SmolLM-135M whole (30 layers,
   the config's chunked attention: 4 KV chunks, remat) at one data rank's
   share of ``train_4k``, 16 x 4,096 tokens, 3 steps in a process of its
   own (``tools/lm_train_peak.py``): the step walls and the peak
   (``max_memory_allocated``, and the backward through the layers' alone)
   beside the dry run's count of the same step at a (1, 1) mesh (counted
   on the host from the start of the script) and the parent commit's
   measured peak (``LM_PEAK_PARENT``), each held under its
   ``LM_PEAK_SHARE`` of the parent's; before it the reduced SmolLM
   at 4 KV chunks, loss and gradients on the card against the CPU.  A
   profiled training step of (a) and its forward alone (the segment
   sum's share forward and backward) run with the other profiler jobs;
10b. the six examples of ``repro_torch.examples`` on the card at their
   defaults (``train_lm`` at 20 steps): each one's wall and printed lines,
   ``quickstart``'s equal to its run on the CPU;
11. sharded training: ``repro_torch.launch.workloads`` train cells on
   ``torch.distributed``, one spawned process a rank, each cell's
   unsharded run on the card first (freed before the ranks spawn) as its
   yardstick: (a) Qwen2-1.5B at its full width (depth cut 28 -> 8
   layers, remat) at (data 2, model 2), 4 ranks on the one card through
   gloo, 3 steps of
   2 x 1,024 tokens, the ZeRO-1 update; the state after step 2 saved by
   the sharded checkpoint and restored at (data 1, model 2), where step 3
   is taken again; (b) DeepSeek-MoE-16B at full width cut to 2 layers
   (seeded non-zero router) at (data 2, model 2): 32 experts a rank, a
   token chunk a data rank, 2 steps of 2 x 512 tokens, each layer's
   routing held against the unsharded run's as integers (a token may
   differ only at a near tie); (c) GatedGCN at phase 10 (a)'s geometry
   (its sampler on phase 8's KG, each batch padded to a multiple of 512
   edges by self-loops of an added node outside the loss) at (data 2),
   10 steps, the segment sum, the sort and the search launched on each
   rank forward and backward (exact counts); (d) the Criteo-scale FM at
   (data 2, model 2), 3 steps of 65,536 rows; (e) world 1 on NCCL: (c)
   and (a) at 2 layers, each sharded run equal to the unsharded one bit
   for bit (deterministic algorithms on).  Each rank's step walls, peak
   memory, collective calls and bytes a step by axes and op, launches a
   step; each step's loss and norm against the yardstick's, beside the
   tolerance (about 10x the largest gap read on an H100).  (a) runs
   sequence-parallel (its residuals split by sequence over ``model``):
   each rank's collective calls and bytes a step, by axes and op, must
   equal the dry run's count of its cell.
12. the serving and engine cells of ``launch/workloads`` (``cells_*``),
   inside phase 11's rank processes after its train cells (no group of
   its own), each against its unsharded run on the card first: (a)
   SmolLM-135M whole at (data 2, model 2): the prefill cell on 4 x 4,096
   tokens, its cache laid out again for the decode cell, 8 decode steps
   (logits within ``CELL_LM_TOL`` of the largest); (b) the Criteo-scale
   FM's serve_bulk (262,144 rows) and retrieval_cand (1,000,000
   candidates) cells, the table replicated, under the config and with
   ``use_pallas=True`` (the FM and bag kernels launch under a mesh;
   scores within ``CELL_FM_RTOL``); (c) the engine cell round_67m over the
   4 ranks on a cut of phase 5's KG with a sameAs delta, card == CPU on
   every rank exactly, the union of the ranks' new rows and rho equal to
   one unsharded round over the whole arena; (d) world 1 on NCCL: (a) and
   (c) through the (1, 1) cells bit for bit against the unsharded
   functions.  Each rank's wall, peak memory, collectives by axes and op
   and launches, beside the dry run's counts of the same cell (rank 0 of
   a fake group of 4): its collective calls and bytes must equal every
   rank's measured ones exactly, its peak is printed beside
   ``max_memory_allocated`` with the ratio, its roofline time beside the
   wall.

Each path's launch counters are set to 0 just before its run and read just
after.  Every wall and every CUDA-event time is taken before the process's
first torch.profiler session: a finished profiler session leaves host cost
on every later launch, which the host-bound REW and LM walls would carry.
Phase 11 runs last, after the profiler jobs: its ranks are fresh processes
(only its yardsticks, in this process, carry the sessions' host cost).
So phase 8 profiles its forward after its own walls, the profiled reruns
of phases 5, 5b and 7, phase 10's profiled step, the search census and
the kernels' device times run after phase 10, then those of 6 and 6b,
and phase 6 then times its traffic once more to show that cost.  These
jobs check no result of the port: each starts only while phase 11, scaled
by how much slower this host ran the phases so far, still fits the run's
limit, and the record names those skipped.  A profiler session whose kept
run holds no device event is made again, up to three in all; a kernel's
device time then falls back to CUDA events (the FM's two kernels also
where the trace kept the rest), a serving rerun to its host walls, and
the record counts each.
Then one JSON line ``{"kernels": [...]}`` and, last, the device line.  The
full record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import gc
import hashlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()  # the run's limit counts from here on

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
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


def counts(entry: str, *args, **data) -> tuple[float, dict]:
    """The bytes and operations (kind -> count) of one launch of C entry
    point ``entry`` on the plain version's ``args``: the dry run's formulas
    (``launch/costs.KERNEL_COUNTS``), given ``data``, what this run's
    values make of the work where it depends on them."""
    from repro_torch.launch.costs import KERNEL_COUNTS

    return KERNEL_COUNTS[entry](*args, **data)


def bound(n_bytes: float, ops: dict) -> tuple[float, str]:
    """The card's least time (ms) for the work, and what sets it
    (``launch/costs.bound``: the datasheet's rates of ``costs.HW``)."""
    from repro_torch.launch.costs import bound as least

    t, by = least(n_bytes, ops)
    return t * 1e3, by


def hbm_ms(n_bytes: float) -> float:
    from repro_torch.launch.costs import HW

    return n_bytes / HW["hbm_bytes_per_s"] * 1e3


def log2c(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def packed_keys(gen, n: int, n_ids: int, dev) -> torch.Tensor:
    spo = torch.randint(0, n_ids, (n, 3), generator=gen, device=dev)
    return (spo[:, 0] << 42) | (spo[:, 1] << 21) | spo[:, 2]


def recorder(records: dict):
    """``record(...)``: print one kernel measurement, fail if the kernel
    and its plain version differ by more than ``tol``, and keep it."""
    def record(name, shape, err, ms, plain_ms, lib_ms, work, main=False, tol=0.0,
               extra=None):
        """``work``: the bytes and operations of :func:`counts`."""
        b_ms, b_by = bound(*work)
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
    # the dry run sizes the wrappers' scratch as the library does on this card
    from repro_torch.launch.costs import CARD_SIZES

    want = [CARD_SIZES["dedup_order_scratch_words"](n) for n in (1, 4096, 4097, stream)]
    got = [ops.dedup_order_scratch_words(n) for n in (1, 4096, 4097, stream)]
    blocks = (ops.segment_sum_max_blocks(), CARD_SIZES["segment_sum_max_blocks"]())
    print(f"  scratch sizes: dedup words {got} (the dry run's {want}), segment-sum "
          f"blocks {blocks[0]} (the dry run's {blocks[1]})", flush=True)
    if got != want or blocks[0] != blocks[1]:
        raise AssertionError("launch/costs.CARD_SIZES differ from the library on this card")
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
               counts("dedup_order", keys), main=n == stream)
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
           counts("dedup_order", keys))



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
           counts("search_bounds", queries, keys, 1), main=True)
    for label, q in (("both sides, n=2^25+1 sorted, v=2^22+1", queries),
                     ("both sides, n=2^22 random, v=2^22+1", search_queries(1 << 22))):
        n = q.shape[0]
        record("search_bounds", label,
               max_err(ops.search_bounds(q, keys), ref.search_bounds(q, keys)),
               time_ms(lambda: ops.search_bounds(q, keys)),
               time_ms(lambda: ref.search_bounds(q, keys)),
               time_ms(lambda: both_sides(q)),
               counts("search_bounds", q, keys))
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
               counts("prefix_range_bounds", prefix, keys))
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
        lookups = 3 * (int(kw["valid"].sum()) if form == "normalise" else n)
        record("rewrite_triples", f"{form} n={n},V={V}", err,
               time_ms(lambda: ops.rewrite_triples(spo, rho, **kw)),
               time_ms(lambda: ref.rewrite_triples(spo, rho, **kw)),
               time_ms(lambda: rho[spo.to(torch.int64)]),
               counts("rewrite_triples", spo, rho, **kw), main=form == "sweep",
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
               None, counts("uf_union", base, buf, pv, n_valid=k, n_ends=n_ends,
                            n_hooked=n_hooked), main=main)
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
               None, counts("uf_compress", hooked, n_moved=n_moved), main=main)
        # the whole merge: reads rep, the flags and the valid rows' pairs,
        # writes the new rep
        record("merge_pairs", f"{label}, V={V}, m={m}", max_err(merged, plain),
               time_ms(lambda: merge_pairs(base, buf, pv)),
               time_ms(lambda: plain_merge(ref, base, buf, pv)),
               None, (m + 8 * k + 8 * V, {"int": 2 * k}), main=main)

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
TRACE_LOST = f"not measured: no device event in {PROFILE_SESSIONS} profiler sessions"


def lost_session(session: int) -> None:
    """Note a session whose kept run holds no device event (or none of a
    kernel it needs) and, unless it was the last one tried, wait a second
    before the next: CUPTI has dropped every kernel of a session begun
    just after another one, and once the FM kernels' events alone."""
    PROFILER_LOST["sessions"] += 1
    print(f"  torch.profiler kept no device event, or none of a kernel needed "
          f"(session {session} of {PROFILE_SESSIONS})", flush=True)
    if session < PROFILE_SESSIONS:
        time.sleep(1.0)


def profiled(fn, need: tuple = ()):
    """``fn()`` twice under torch.profiler, keeping the second run's trace:
    CUPTI can miss the first kernels launched after tracing starts (a
    profiled GNN forward has lost its first two, the segment plan's sort
    and search), so the first run is the profiler's warm-up step.  A
    session whose kept run holds no device event, or no device time of a
    port kernel named in ``need``, is made again, up to
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
        busy = device_time(prof, wall)
        if busy["busy_ms"] > 0 and all(busy["port_kernels_ms"].get(k, 0.0) > 0
                                       for k in need):
            break
        lost_session(session)
    return prof, wall, out


def event_kernel_ms(ops, fn, names: list) -> dict:
    """Device ms of the port kernels ``names`` in one run of ``fn`` (after
    a warm-up run), by CUDA events around each call of their wrappers in
    ``ops`` (so the wrapper's own device work, such as zeroing an output,
    is in it): for a profiled run whose trace kept the other kernels but
    lost these.  Counted in ``PROFILER_LOST``."""
    spans: dict = {name: [] for name in names}
    wrappers = {name: getattr(ops, name) for name in names}

    def timed(name, wrapper):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = wrapper(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    for name in names:
        setattr(ops, name, timed(name, wrappers[name]))
    try:
        fn()
        torch.cuda.synchronize()
        for kept in spans.values():
            kept.clear()
        fn()
        torch.cuda.synchronize()
    finally:
        for name in names:
            setattr(ops, name, wrappers[name])
    if not all(spans.values()):
        raise AssertionError(f"no call of {[n for n in names if not spans[n]]}")
    PROFILER_LOST["event_timed"] += 1
    print(f"  CUDA-event time of {', '.join(names)} instead", flush=True)
    return {name: sum(s.elapsed_time(e) for s, e in spans[name]) for name in names}


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
    1,024-row cache at q_offset 700; at the MoE models' heads (D 128):
    DeepSeek's prefill of 512 tokens (16 over 16 heads), Qwen3's (64 over
    4) and a decode step of 16 rows at G 16; the FM interaction at the FM's
    ``serve_p99`` and ``serve_bulk`` batches (39 fields, K 10, f32).
    SDPA is flash's yardstick: causal at offset 0, and for the decode
    step on the keys up to q_offset, unmasked.  The device times under
    torch.profiler go to ``later``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION]

    record = recorder(records)
    gen = torch.Generator(device=dev).manual_seed(1)
    for b, s, t, h, kv, d, off, label, main in (
        (1, 512, 512, 9, 3, 64, 0, "prefill (1, 512, 9/3, 64)", True),
        (1, 32768, 32768, 9, 3, 64, 0, "prefill (1, 32768, 9/3, 64)", False),
        (16, 1, 1024, 9, 3, 64, 700,
         "decode (16, 1, T 1024, 9/3, 64) at q_offset 700", False),
        # the MoE models' heads (phase 6b): DeepSeek's MHA, Qwen3's G 16
        (1, 512, 512, 16, 16, 128, 0, "prefill (1, 512, 16/16, 128)", False),
        (1, 512, 512, 64, 4, 128, 0, "prefill (1, 512, 64/4, 128)", False),
        (16, 1, 1024, 64, 4, 128, 700,
         "decode (16, 1, T 1024, 64/4, 128) at q_offset 700", False),
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
        # the bound's bytes: q and out once and the K/V rows the causal mask
        # admits once; its FLOPs: each query's admitted keys
        record("flash_attention", label, err, time_ms(flash, reps=FLASH_REPS),
               time_ms(lambda: ref.flash_attention(q, k, v, q_offset=off)),
               lib_ms, counts("flash_attention", q, k, v, True, off), main=main,
               tol=FLASH_TOL)
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
               None, counts("fm_interact", x), main=main,
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
           counts("dedup_order", keys))
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

        record("segment_sum", f"KG in-edges E={e}, n={n}, K={k} {str(dtype)[6:]}",
               err, time_ms(kernel), time_ms(lambda: ref.segment_sum(x, seg, n)),
               time_ms(library), counts("segment_sum", x, seg, n), main=main, tol=tol)
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
               counts("embedding_bag", ids, tab, sectors=touched_sectors(ids, tab)),
               main=main, tol=tol)
        entry = records["embedding_bag"][-1]
        # the bound as if every lookup read its row's sectors from device
        # memory: ceil(4K / 32) sectors a lookup, none of them held by L2
        entry["lookup_sectors_bound_ms"], _ = bound(*counts("embedding_bag", ids, tab))
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
    prompts = seeded_prompts(cfg.vocab)

    def serve(n_requests: int):
        eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_id=-1)
        for i, p in enumerate(prompts[:n_requests]):
            eng.submit(Request(uid=i, prompt=p, max_new=LM_NEW))
        return eng

    return cfg, params, serve


def seeded_prompts(vocab: int) -> list:
    """The LM phases' 64 requests: 32-512 prompt tokens drawn from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, int(n)).tolist()
            for n in rng.integers(32, 513, LM_REQUESTS)]


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
                flash_ms = busy["port_kernels_ms"].get("flash_attention", 0.0)
                busy["flash_share_of_wall"] = flash_ms / 1e3 / profiled_wall
                busy["flash_share_of_busy"] = flash_ms / busy["busy_ms"]
                break
            lost_session(session)
        else:  # the host walls stand for it
            busy = TRACE_LOST
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


# -- phase 6b: MoE serving at full width ----------------------------------------

MOE_DEEPSEEK, MOE_QWEN = "deepseek-moe-16b", "qwen3-moe-235b-a22b"
MOE_QWEN_LAYERS = 4  # of Qwen3-MoE-235B's 94 (5.0 GB a layer in bf16): ~21 GB
MOE_QWEN_PROMPT, MOE_QWEN_STEPS = 512, 16
# card against CPU: each model cut to these layers, teacher-forced over the
# prompt and this many of the request's generated tokens
MOE_CPU_CUT = {MOE_DEEPSEEK: (2, LM_NEW - 1), MOE_QWEN: (1, 16)}
MOE_FLIP_MARGIN = 1e-3  # a routing flip at a wider gap between card and CPU fails
MOE_LOGIT_TOL = LM_LOGIT_TOL  # bf16 logits below 8, after one or two layers here


def moe_model(name: str, n_layers: int | None = None):
    """An MoE config at full width with the flash kernel (its depth cut to
    ``n_layers`` where given), random weights from seed 0 and a seeded
    router (normal / sqrt(d), f32): the reference's router of zeros ties
    every expert, so every token would take experts 0..K-1 and a 512-token
    prefill would drop most of its pairs."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as lm

    cfg = dataclasses.replace(get_arch(name).config, attn_impl="flash")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    router = params["layers"]["router"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    params["layers"]["router"] = torch.randn(
        router.shape, generator=gen, device=router.device) / cfg.d_model**0.5
    return cfg, params


def _tensors(params) -> list:
    return [params["embed"], params["final_norm"], *params["layers"].values()]


def moe_server(params, cfg, prompts: list, max_new: int, logits: list | None = None,
               keep: int = 0):
    """A ServeEngine (phase 6's slots and rows) with ``prompts`` submitted;
    with ``logits`` the first ``keep`` batches of logits it samples from
    are cloned into that list."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_id=-1)
    if logits is not None:
        sample = eng.sample

        def kept(x):
            if len(logits) < keep:
                logits.append(x.clone())
            return sample(x)

        eng.sample = kept
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=max_new))
    return eng


def expert_load(log) -> dict:
    """A routing log's (token, k) pairs by expert, summed over its calls
    (every slot of a decode step routes, inactive ones too), and the share
    that capacity dropped: in all, and by the chunk's token count (16 a
    batched decode step, a prompt's length a prefill)."""
    load = log.load.cpu()
    kept = int(log.kept.sum())
    split = {}
    for n, (pairs, kept_n) in log.by_tokens.items():
        key = "decode" if n == LM_SLOTS else "prefill"
        tally = split.setdefault(key, [0, 0])
        tally[0] += pairs
        tally[1] += int(kept_n)
    return dict(calls=log.calls, pairs=log.pairs, kept=kept,
                dropped_share=1.0 - kept / log.pairs,
                **{f"dropped_share_{key}": 1.0 - k / p for key, (p, k) in split.items()},
                load_min=int(load.min()), load_max=int(load.max()),
                load_max_over_mean=float(load.max() / load.float().mean()),
                load=load.tolist())


def _top_sets(routes: list) -> list:
    return [r["gate_idx"].sort(-1).values for r in routes]


def routing_flips(card: list, host: list, n_layers: int) -> list:
    """Card against CPU, call by call, the CPU replaying the card's routing
    (``host`` holds its router's own top k): the tokens whose top-k sets
    differ, each with the CPU's gap between its K-th and (K+1)-th
    probabilities and the largest difference of the two sides'
    probabilities of that token.  With the routing held equal the two
    sides differ by rounding alone, so a flip fails at a gap above
    ``MOE_FLIP_MARGIN`` or above twice that difference."""
    if len(card) != len(host):
        raise AssertionError(f"{len(card)} MoE calls on the card, {len(host)} on the CPU")
    out = []
    for n, (c, h, cs, hs) in enumerate(zip(card, host, _top_sets(card), _top_sets(host))):
        k = c["gate_idx"].shape[-1]
        noise = (c["probs"] - h["probs"]).abs().amax(-1)
        top = h["probs"].sort(-1, descending=True).values
        for idx in (cs != hs).any(-1).nonzero().tolist():
            tok = tuple(idx)
            flip = dict(step=n // n_layers, layer=n % n_layers, token=idx[-1],
                        margin=float(top[tok][k - 1] - top[tok][k]),
                        noise=float(noise[tok]))
            if not (flip["margin"] <= MOE_FLIP_MARGIN
                    and flip["margin"] <= 2 * flip["noise"]):
                raise AssertionError(f"routing flip at a wide gap: {flip}")
            out.append(flip)
    return out


def moe_card_vs_cpu(cfg, params, reqs: list) -> dict:
    """The model cut to ``MOE_CPU_CUT``'s layers, its weights the card's
    first layers, on the card and on the CPU: the teacher-forced logits of
    ``reqs`` ((prompt, generated tokens) pairs) and each MoE call's
    routing.  The CPU runs twice.  Free: its logits within
    ``MOE_LOGIT_TOL`` at the steps before its routing first parts from the
    card's (a flip moves that token's output, and through attention the
    later tokens', so the free run's later flips follow from its first).
    Replaying the card's routing: its router's own choices held to
    :func:`routing_flips` call by call, its logits to ``MOE_LOGIT_TOL`` at
    every step."""
    from repro_torch.models import moe, transformer as lm
    from repro_torch.serve import Request

    n_layers, steps = MOE_CPU_CUT[cfg.name]
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    card = dict(params, layers={k: v[:n_layers] for k, v in params["layers"].items()})
    host = _tree_to(card, "cpu")
    t0 = time.perf_counter()
    out = []
    for prompt, generated in reqs:
        req = Request(uid=0, prompt=prompt, out=generated[:steps + 1])
        logs, logits = {}, {}
        for side, p in (("card", card), ("free", host)):
            with moe.routing_log(moe.RoutingLog(keep_calls=True)) as logs[side]:
                logits[side] = _teacher_forced_logits(lm, p, cut, req)
        if not torch.isfinite(logits["card"]).all():
            raise AssertionError("non-finite logits")
        replay = [r["gate_idx"] for r in logs["card"].routes]
        with moe.routing_log(moe.RoutingLog(keep_calls=True, replay=replay)) as log:
            replayed = _teacher_forced_logits(lm, host, cut, req)
        flips = routing_flips(logs["card"].routes, log.routes, n_layers)
        parted = [n for n, (a, b) in enumerate(zip(_top_sets(logs["card"].routes),
                                                   _top_sets(logs["free"].routes)))
                  if not torch.equal(a, b)]
        clean = parted[0] // n_layers if parted else len(logits["card"])
        err = (logits["card"] - logits["free"]).abs().amax(-1)  # a step's largest
        entry = dict(prompt_len=len(prompt), steps=len(err), flips=len(flips),
                     flip_margin_max=max((f["margin"] for f in flips), default=None),
                     first_flips=flips[:8], free_run_parted_calls=len(parted),
                     steps_before_parting=clean,
                     max_abs_err_before_parting=float(err[:clean].max()) if clean else None,
                     max_abs_err_replayed=float((logits["card"] - replayed).abs().max()))
        for key in ("max_abs_err_before_parting", "max_abs_err_replayed"):
            if entry[key] is not None and not entry[key] <= MOE_LOGIT_TOL:
                raise AssertionError(f"{cfg.name} card against CPU: {key} "
                                     f"{entry[key]} > {MOE_LOGIT_TOL}")
        out.append(entry)
    del card, host
    return dict(n_layers=n_layers, tol=MOE_LOGIT_TOL, flip_margin=MOE_FLIP_MARGIN,
                requests=out, cpu_s=time.perf_counter() - t0)


def _free_card() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def moe_deepseek(ops, records: dict, later: list) -> tuple[int, list]:
    """Phase 6b (a): DeepSeek-MoE-16B whole.  Returns its run's flash
    launches and the shortest request and the one nearest 128 prompt
    tokens, as (prompt, generated tokens), for the card-against-CPU checks."""
    from repro_torch.models import moe

    cfg, params = moe_model(MOE_DEEPSEEK)
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, want {cfg.param_count()}")
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    prompts = seeded_prompts(cfg.vocab)
    warm = moe_server(params, cfg, prompts[:2], LM_NEW)  # cuBLAS, the kernel's module
    warm.run()
    del warm
    _free_card()

    # (1) the traffic, timed; (2) again under a routing log, whose first
    # wave's logits (every request admitted in the first tick, evicted
    # together after LM_NEW - 1 decode steps) are kept; (3) the first wave
    # alone, its logits kept: (2) and (3) must agree bit for bit
    wave = LM_SLOTS + LM_NEW - 1  # sampling calls of the first wave
    eng = moe_server(params, cfg, prompts, LM_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    st = eng.stats
    arena = sum(t.numel() * t.element_size() for t in eng.cache.values())
    del eng
    if sorted(r.uid for r in done) != list(range(LM_REQUESTS)):
        raise AssertionError("not every request finished")
    if any(len(r.out) != LM_NEW or not all(0 <= t < cfg.vocab for t in r.out)
           for r in done):
        raise AssertionError("a request stopped short or left the vocabulary")
    if launches["flash_attention"] != LM_REQUESTS * cfg.n_layers:
        raise AssertionError(f"flash launches {launches['flash_attention']}, want "
                             f"{LM_REQUESTS * cfg.n_layers}")
    outs = {r.uid: r.out for r in done}

    logged, alone = [], []
    eng = moe_server(params, cfg, prompts, LM_NEW, logged, keep=wave)
    with moe.routing_log() as log:
        again = eng.run()
    load = expert_load(log)
    del eng, log
    eng = moe_server(params, cfg, prompts[:LM_SLOTS], LM_NEW, alone, keep=wave)
    first = eng.run()
    del eng
    if any(outs[r.uid] != r.out for r in [*again, *first]):
        raise AssertionError("two card runs gave other tokens")
    if len(alone) != wave or not all(torch.equal(a, b) for a, b in zip(logged, alone)):
        raise AssertionError("two card runs of the first wave gave other logits")
    del logged, alone

    def profile_rerun():
        """The first wave again under torch.profiler, the model made anew."""
        cfg, params = moe_model(MOE_DEEPSEEK)
        prompts = seeded_prompts(cfg.vocab)[:LM_SLOTS]
        for session in range(1, PROFILE_SESSIONS + 1):
            again = moe_server(params, cfg, prompts, LM_NEW)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                again.run()
                torch.cuda.synchronize()
                profiled_wall = time.perf_counter() - t0
            busy = device_time(prof, profiled_wall)
            if busy["busy_ms"] > 0:
                flash_ms = busy["port_kernels_ms"].get("flash_attention", 0.0)
                busy["flash_share_of_busy"] = flash_ms / busy["busy_ms"]
                break
            lost_session(session)
        else:  # the host walls stand for it
            busy = TRACE_LOST
        rerun = dict(profiled_requests=LM_SLOTS, profiled_wall_s=profiled_wall,
                     device_time=busy)
        print(f"  MoE serving (DeepSeek), profiled rerun: {json.dumps(rerun)}",
              flush=True)
        records["moe_serving"]["deepseek"].update(rerun)
        del again, params
        _free_card()

    later.append(profile_rerun)
    gen_tokens = LM_REQUESTS * LM_NEW
    out = dict(
        config=cfg.name, params=n_params, active_params=cfg.active_param_count(),
        weight_bytes=w_bytes, layers=cfg.n_layers, experts=cfg.n_experts,
        top_k=cfg.top_k, shared=cfg.n_shared, requests=LM_REQUESTS, slots=LM_SLOTS,
        max_len=LM_MAX_LEN, max_new=LM_NEW, prompt_tokens=st.prefill_tokens,
        wall_s=wall, generated_tokens_per_s=gen_tokens / wall,
        prefill_s=st.prefill_seconds,
        prefill_tokens_per_s=st.prefill_tokens / st.prefill_seconds,
        decode_steps=st.decode_steps, decode_tokens=st.decode_tokens,
        decode_s=st.decode_seconds,
        decode_tokens_per_s=st.decode_tokens / st.decode_seconds,
        decode_step_ms=st.decode_seconds / st.decode_steps * 1e3,
        # every decode step runs every expert over at least one row and the
        # logits read the embedding: all weights once
        decode_step_bound_ms=hbm_ms(w_bytes),
        arena_bytes=arena, max_memory_allocated=peak, max_memory_reserved=reserved,
        launches=launches, expert_load=load, same_tokens_twice=True,
        first_wave_logits_bit_equal=True,
    )
    print(f"  {json.dumps({k: v for k, v in out.items() if k != 'expert_load'})}",
          flush=True)
    print(f"  expert load: {json.dumps({k: v for k, v in load.items() if k != 'load'})}",
          flush=True)
    by_len = sorted(done, key=lambda r: len(r.prompt))
    mid = min(done, key=lambda r: (abs(len(r.prompt) - 128), r.uid))
    reqs = [(r.prompt, r.out) for r in (by_len[0], mid)]
    out["card_vs_cpu"] = moe_card_vs_cpu(cfg, params, reqs)
    print(f"  card against CPU: {json.dumps(out['card_vs_cpu'])}", flush=True)
    records["moe_serving"] = {"deepseek": out}
    del params
    _free_card()
    return launches["flash_attention"], reqs


def moe_qwen3(ops, records: dict, reqs: list) -> None:
    """Phase 6b (b): Qwen3-MoE-235B at full width, its depth cut to
    ``MOE_QWEN_LAYERS``: one prefill of 512 tokens and 16 decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, transformer as lm

    published = get_arch(MOE_QWEN).config.n_layers
    cfg, params = moe_model(MOE_QWEN, MOE_QWEN_LAYERS)
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, want {cfg.param_count()}")
    w_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    prompt = np.random.default_rng(2).integers(2, cfg.vocab, MOE_QWEN_PROMPT).tolist()
    warm = moe_server(params, cfg, [prompt], 2)
    warm.run()
    del warm
    _free_card()
    eng = moe_server(params, cfg, [prompt], MOE_QWEN_STEPS + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    del eng
    if len(done) != 1 or len(done[0].out) != MOE_QWEN_STEPS + 1:
        raise AssertionError("the request did not finish")
    if st.decode_steps != MOE_QWEN_STEPS:
        raise AssertionError(f"{st.decode_steps} decode steps")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash launches {launches['flash_attention']}, want "
                             f"{cfg.n_layers}")
    with moe.routing_log() as log:  # the prefill's routing, untimed
        lm.prefill(params, cfg, torch.tensor([prompt], device="cuda"))
    out = dict(
        config=cfg.name, layers=cfg.n_layers, layers_published=published,
        reduced=[f"n_layers {published} -> {cfg.n_layers}: the weights of "
                 f"{published} layers do not fit one card"],
        params=n_params, weight_bytes=w_bytes, experts=cfg.n_experts,
        top_k=cfg.top_k, prompt_tokens=st.prefill_tokens, wall_s=wall,
        prefill_s=st.prefill_seconds, decode_steps=st.decode_steps,
        decode_s=st.decode_seconds,
        decode_step_ms=st.decode_seconds / st.decode_steps * 1e3,
        decode_step_bound_ms=hbm_ms(w_bytes),
        max_memory_allocated=peak, launches=launches,
        prefill_expert_load=expert_load(log),
    )
    del log
    print(f"  {json.dumps({k: v for k, v in out.items() if k != 'prefill_expert_load'})}",
          flush=True)
    out["card_vs_cpu"] = moe_card_vs_cpu(cfg, params, reqs)
    print(f"  card against CPU: {json.dumps(out['card_vs_cpu'])}", flush=True)
    records["moe_serving"]["qwen3"] = out
    del params
    _free_card()


def moe_serving_phase(ops, records: dict, later: list) -> int:
    """Phase 6b; returns DeepSeek's flash launches."""
    flash, reqs = moe_deepseek(ops, records, later)
    moe_qwen3(ops, records, reqs)
    return flash


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
        need = ("fm_interact", "embedding_bag")

        def step():
            return recsys.serve_step(fm["params"], fm["cfg"], batch)

        before = {name: ops.LAUNCHES[name] for name in need}
        prof, wall, _ = profiled(step, need=need)
        busy = device_time(prof, wall)
        # the profiled steps went through both kernels: a launch each a step,
        # two steps a session
        launched = {name: ops.LAUNCHES[name] - before[name] for name in need}
        if any(n < 2 or n % 2 for n in launched.values()) or \
                len(set(launched.values())) != 1:
            raise AssertionError(f"FM profile: launches {launched} in sessions "
                                 "of two steps")
        lost = [name for name in need if busy["port_kernels_ms"].get(name, 0.0) <= 0]
        if lost:  # the trace lost these (and maybe the rest): the busy share
            # is not the step's
            busy["port_kernels_ms"].update(event_kernel_ms(ops, step, lost))
            busy["event_timed_kernels"] = lost
            busy["busy_share"] = None
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
    # the dedup's sort, and the forward's plans of dst and src
    want = dict(segment_sum=2 * cfg.n_layers, rewrite_triples=1, dedup_order=3,
                search_bounds=2)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"main path launches {launches}, want {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("full size: non-finite logits")
    kg["dedup_edge_index"] = dedup["edge_index"].cpu().numpy()  # phase 10's graph
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
        factors = stats.factor_over(ax.stats)
        print(f"  {name}: cuda fused == cuda host loop == cpu fused == cpu host "
              f"loop, {counters}; "
              f"Theorem 1 holds against the host AX ({ax.stats.triples_unmarked} "
              f"triples); AX/REW factors {json.dumps(factors)}; "
              f"{json.dumps(walls)}", flush=True)
        records[name] = dict(counters, rule_rewrites=stats.rule_rewrites,
                             ax_triples=ax.stats.triples_unmarked,
                             factor_over_ax=factors, **walls)


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


def full_engine(n_resources: int, **kw):
    """A full-size engine on the card: the ``sameas_rew`` config with phase
    5's caps (2^22) through ``TorchEngine.from_config``."""
    from repro_torch import TorchEngine
    from repro_torch.configs import get_arch

    return TorchEngine.from_config(
        get_arch("sameas_rew").config, n_resources=n_resources, device="cuda",
        capacity=FULL_CAP, bind_cap=FULL_CAP, out_cap=FULL_CAP,
        rewrite_cap=FULL_CAP, **kw)


class LaunchCensus:
    """Kernel launches by entry point and leading operand rows, handed over
    by ``ops.traced``: the eager ones, and those recorded into a graph
    capture (by the capture's dict of calls, which the graph keeps as
    ``calls``), which each replay of that graph launches again."""

    def __init__(self) -> None:
        self.live: dict = {}
        self.captured: dict = {}

    def launch(self, fn, operands, capture) -> None:
        key = (fn, int(operands[0].shape[0]) if operands else 0)
        into = self.live if capture is None else self.captured.setdefault(
            id(capture), {})
        into[key] = into.get(key, 0) + 1

    def plain(self, fn):
        raise AssertionError(f"a plain version ran on the card: {fn}")

    def by_rows(self, fn: str, graphs) -> dict:
        """Launches of ``fn`` by leading rows: eager, plus each graph's
        captured ones times its replays."""
        out: dict = {}
        for (name, rows), n in self.live.items():
            if name == fn:
                out[rows] = out.get(rows, 0) + n
        for g in graphs:
            for (name, rows), n in self.captured.get(id(g.calls), {}).items():
                if name == fn:
                    out[rows] = out.get(rows, 0) + n * g.replays
        return dict(sorted(out.items()))


def crosscheck(label: str, engine, program) -> dict:
    """``engine.dispatches`` reconciled with the static phase profile;
    raises on any problem.  Returns the dispatches by family and phase."""
    from repro_torch.analysis import dispatch_crosscheck

    d = engine.dispatches
    problems = dispatch_crosscheck(d, program)
    if problems:
        raise AssertionError(f"{label}: dispatch cross-check: {problems}")
    return dict(by_family=dict(d.by_family), compiles=dict(d.compiles),
                by_phase={f"{ph}/{fam}": n for (ph, fam), n in sorted(
                    d.by_phase.items(), key=lambda kv: (str(kv[0][0]), kv[0][1]))
                    if ph is not None})


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


def rew_run(ops, eng, facts, program, census=None):
    """One materialisation on the card: its state, and its wall (ending in
    a synchronise), launch counts and dispatches by family (both set to 0
    just before), peak memory allocated and reserved (the caching
    allocator's segments, a CUDA graph's private pool included) and the
    engine's wall split.  A ``census`` (:class:`LaunchCensus`) gets the
    run's launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    eng.dispatches.reset()
    t0 = time.perf_counter()
    if census is None:
        state = eng.materialise_state(facts, program)
    else:
        with ops.traced(census):
            state = eng.materialise_state(facts, program)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, dict(
        wall_s=wall, launches=dict(ops.LAUNCHES),
        dispatches=dict(eng.dispatches.by_family),
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
    from repro_torch.configs import get_arch
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

    host_eng = full_engine(dic.n_resources, fuse_rounds=False)
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

    eng = full_engine(dic.n_resources)
    torch.cuda.empty_cache()
    census = LaunchCensus()
    state, first = rew_run(ops, eng, facts, program, census)
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
    dedup_by_keys = census.by_rows("dedup_order", eng._graphs.values())
    if sum(dedup_by_keys.values()) != launches["dedup_order"]:
        raise AssertionError(f"dedup_order census {dedup_by_keys} != "
                             f"{launches['dedup_order']} launches")
    if first["dispatches"].get("fforward") != stats.rounds:
        raise AssertionError(f"{stats.rounds} rounds, dispatches "
                             f"{first['dispatches']}")
    rew_crosscheck = crosscheck("REW base run", eng, program)
    print(f"  fused, first run: dispatches by family {json.dumps(first['dispatches'])}"
          f" (compiles {json.dumps(rew_crosscheck['compiles'])}); dedup_order "
          f"launches by key count {json.dumps(dedup_by_keys)}", flush=True)

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
    # the dispatch counter's host cost: one record call (median of 5 spans
    # of 100,000), against a rerun's wall at its dispatches
    counter, n_calls, spans = type(eng.dispatches)(), 100_000, []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            counter.record("fforward")
        spans.append((time.perf_counter() - t0) / n_calls)
    record_s = statistics.median(spans)
    record_cost = dict(
        record_us=record_s * 1e6,
        share_of_rerun_wall=record_s * sum(reruns[0]["dispatches"].values())
        / reruns[0]["wall_s"])
    print(f"  the dispatch counter: {json.dumps(record_cost)}", flush=True)

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
    kg["triples"] = live
    kg["counters"] = {k: getattr(stats, k) for k in COUNTERS}
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
        launches=launches, dispatches=first["dispatches"],
        dedup_order_by_keys={str(k): n for k, n in dedup_by_keys.items()},
        crosscheck=rew_crosscheck, host_loop_dispatches=host_runs[0]["dispatches"],
        dispatch_record_cost=record_cost,
        config=dataclasses.asdict(get_arch("sameas_rew").config),
        quiet_sweep=quiet, dedup_rows_s=dedup_rows_s,
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
    eng = full_engine(FULL_RESOURCES)
    torch.cuda.empty_cache()
    state = eng.materialise_state(facts, program)
    torch.cuda.synchronize()
    base_state = TorchEngine.cloned(state)
    scratch = full_engine(FULL_RESOURCES)
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

    inc_crosscheck = crosscheck("the 8 update events", eng, program)
    print(f"  dispatches of the base run and the 8 events reconcile with the "
          f"static profile: {json.dumps(inc_crosscheck)}", flush=True)

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
                lambda op=op: apply_event(eng, TorchEngine.cloned(base_state), op,
                                          first[op]))
            out[op] = dict(profiled_wall_s=wall, device_time=device_time(prof, wall))
        print(f"  incremental, profiled add and delete: {json.dumps(out)}", flush=True)
        records["incremental_fullsize"]["profiled"] = out

    later.append(profile_updates)
    out = dict(events=per_event, sample_s=sample_s, host_setup_s=host_setup_s,
               host_subsystem=host_walls, launches=total,
               caps=dict(delta_out=eng.delta_out, delta_bind=eng.delta_bind,
                         delta_rewrite=eng.delta_rewrite),
               captures=eng.captures, crosscheck=inc_crosscheck)
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
    store = TripleStore(facts, program, dic, engine=full_engine(FULL_RESOURCES))
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
    dc = store.launch_counts
    problems = store.audit()
    if problems:
        raise AssertionError(f"the cooperative store's audit: {problems}")
    out["dispatch_ledger"] = store.dispatch_counts
    idle_p50 = out["idle"]["per_query_ms"]["p50"]
    out["busy"] = dict(
        events=per_event, per_query_ms=ms_stats([t.wall_s for t in busy]),
        epochs_read=sorted({t.epoch for t in busy}), check_s=check_s,
        publish_ms=store.publish_ms, publish_split=store.publish_split,
        stats=dict(bx.stats))
    out["busy_over_idle"] = out["busy"]["per_query_ms"]["p50"] / idle_p50
    out["launches"] = launches
    out["launch_counts"] = dc
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
                           engine=full_engine(FULL_RESOURCES))
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
        captures = dict(threaded.engine.dispatches.compiles)
        threaded_problems = threaded.audit()
        threaded_ledger = threaded.dispatch_counts
    finally:
        threaded.close()
    if threaded_problems:
        raise AssertionError(f"the threaded store's audit: {threaded_problems}")
    for t in answered:
        if t.answer != oracles[t.epoch].answer(t.query, dic):
            raise AssertionError(f"threaded query {t.uid}: != scalar at epoch {t.epoch}")
    for s in tsnaps:
        same_snapshot(f"threaded epoch {s.epoch} vs cooperative", s, coop[s.epoch])
    out["threaded"] = dict(
        build_s=build_s, wall_s=wall, bursts=reads_busy, answers=len(answered),
        epochs_read=sorted({t.epoch for t in answered}), captures=captures,
        dispatch_ledger=threaded_ledger,
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


# violations the card's audit may report: none (ROADMAP Queue 3 would list
# each with its family, op and size)
AUDIT_ALLOWED: list = []
AUDIT_DATASETS = ("pex", "chain", "clique", "dbpedia_like")


def audit_phase(records: dict) -> None:
    """The trace audit on the card at the probe geometry of each probe
    dataset (``run_report``: every registered unit recorded once with its
    launches, the four passes, a driven delete and add cross-checked), then
    the full-size cross-checks phases 5, 5b and 5c made.  Raises on a
    violation outside ``AUDIT_ALLOWED``, a dispatch problem, or a REW
    kernel that no unit launched."""
    from repro_torch.analysis import run_report

    out = {}
    for name in AUDIT_DATASETS:
        t0 = time.perf_counter()
        report = run_report(name, device="cuda")
        wall = time.perf_counter() - t0
        extra = [v for v in report["violations"] if v not in AUDIT_ALLOWED]
        if extra:
            raise AssertionError(f"audit {name}: violations {extra}")
        if report["dispatch"]["problems"]:
            raise AssertionError(f"audit {name}: {report['dispatch']['problems']}")
        launched = set().union(*map(set, report["launches"].values()))
        missing = [k for k in (*REW_KERNELS, "prefix_range_bounds")
                   if k not in launched]
        if missing:
            raise AssertionError(f"audit {name}: no unit launched {missing}")
        out[name] = dict(wall_s=wall, fns=len(report["fns"]),
                         arena_rows=report["arena_rows"],
                         violations=report["violations"],
                         launches=report["launches"],
                         runtime_by_phase=report["dispatch"]["runtime_by_phase"])
        print(f"  {name}: {len(report['fns'])} units, arena "
              f"{report['arena_rows']}, no violation, no dispatch problem, "
              f"{wall:.2f} s; launches {json.dumps(report['launches'])}; "
              f"dispatches {json.dumps(report['dispatch']['runtime_by_phase'])}",
              flush=True)
    full = dict(
        rew=records["fullsize"]["crosscheck"],
        updates=records["incremental_fullsize"]["crosscheck"],
        serving=records["serving_fullsize"]["dispatch_ledger"],
        serving_threaded=records["serving_fullsize"]["threaded"]["dispatch_ledger"],
    )
    print(f"  full size: the dispatch cross-checks of phases 5, 5b and 5c (both "
          f"stores) found no problem; phase 5c's ledger "
          f"{json.dumps(full['serving']['by_phase'])}", flush=True)
    records["audit"] = dict(probe=out, fullsize=full)


# -- the sharded engine (torch.distributed) -------------------------------------

# each mid-size profile's (loop, exchange) at world 1 and at world 2, so
# each world covers both loops, gathering and routing
SHARD_MID_COMBOS = (("fused", None), ("fused", 256), ("host", None),
                    ("host", 256))
SHARD_MID_EVENTS = dict(n_events=4, batch=24, seed=0)
# owner buckets that hold a full-size round's stream: at world 1 the one
# bucket takes every row of a round (2^24 overflows in round 1 and grows
# to 2^25); at world 2 each bucket takes about a quarter, and 2^24 holds
SHARD_FULL_ROUTE = {1: 1 << 25}
SHARD_FULL_ROUTE_MANY = 1 << 24
SHARD_FULL_RUNS = 3  # the first run and two reruns
SHARD_TIMEOUT_S = 300.0


def _shard_device(backend: str, rank: int) -> str:
    """NCCL gives each rank its own card; gloo puts every rank on card 0."""
    return f"cuda:{rank}" if backend == "nccl" else "cuda:0"


def _shard_stats(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items()
            if k not in ("mode", "wall_seconds", "triples_unmarked")}


def _shard_mid(rank: int, world: int, mesh, cpu_mesh, device: str) -> dict:
    """Phase 9 (a) on one rank: each mid-size profile's base run and 4
    events on the card and the CPU through meshes of the same size, each
    rank's arrays, rho and counters equal after each; the gathered store
    and rho equal the unsharded card engine's."""
    from repro_torch import TorchEngine
    from repro_torch.core.engine import state_to_arrays
    from repro_torch.data.generator import PROFILES, generate, sample_update_stream

    out = {}
    for i, name in enumerate(MIDSIZE):
        loop, route = SHARD_MID_COMBOS[(i + 2 * (world > 1)) % 4]
        facts, program, dic = generate(**PROFILES[name])
        events = sample_update_stream(facts, dic, **SHARD_MID_EVENTS)
        n_res = dic.n_resources
        kw = dict(fuse_rounds=loop == "fused", route_cap=route)
        card = TorchEngine(n_res, device=device, mesh=mesh, **kw)
        cpu = TorchEngine(n_res, device="cpu", mesh=cpu_mesh, **kw)
        flat = TorchEngine(n_res, device=device)
        t0 = time.perf_counter()
        states = [e.materialise_state(facts, program) for e in (card, cpu, flat)]
        walls = [time.perf_counter() - t0]
        for step in range(len(events) + 1):
            if step:
                op, delta = events[step - 1]
                ta = time.perf_counter()
                for e, s in zip((card, cpu, flat), states):
                    apply_event(e, s, op, delta)
                walls.append(time.perf_counter() - ta)
            tag = f"{name} world {world} rank {rank} step {step}"
            a, b = state_to_arrays(states[0]), state_to_arrays(states[1])
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"{tag}: card vs cpu: {k} differs")
            if _shard_stats(states[0].stats) != _shard_stats(states[1].stats):
                raise AssertionError(f"{tag}: card vs cpu: counters differ")
            same_store(f"{tag}: sharded vs unsharded", card.state_rep(states[0]),
                       card.state_triples(states[0]), flat.state_rep(states[2]),
                       flat.state_triples(states[2]))
        st = states[0].stats
        out[name] = dict(loop=loop, route_cap=route, steps=len(events) + 1,
                         ops=[op for op, _ in events], walls_s=walls,
                         rounds=st.rounds, od_waves=st.od_waves,
                         overdeleted=st.overdeleted,
                         capacity_retries=st.capacity_retries,
                         graphs=card.last_split["graphs"],
                         collectives=mesh.counts())
        mesh.reset_counts()
        del card, cpu, flat, states
        torch.cuda.empty_cache()
    return out


def _shard_full(rank: int, world: int, mesh, device: str, spec: dict) -> dict:
    """Phase 9 (b)/(c) on one rank: phase 5's facts through the sharded
    fused engine at phase 5's caps, the first run and the reruns, each
    rank's launches and collectives; the gathered store and rho equal the
    unsharded fused engine's of phase 5."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import TorchEngine
    from repro_torch.core.triples import pack
    from repro_torch.kernels import ops

    facts = np.load(spec["facts"])
    with open(spec["program"], "rb") as f:
        program = pickle.load(f)
    route_cap = SHARD_FULL_ROUTE.get(world, SHARD_FULL_ROUTE_MANY)
    eng = TorchEngine.from_config(
        get_arch("sameas_rew").config, mesh=mesh, n_resources=spec["n_res"],
        device=device, capacity=FULL_CAP, bind_cap=FULL_CAP, out_cap=FULL_CAP,
        rewrite_cap=FULL_CAP, route_cap=route_cap)
    runs = []
    for i in range(SHARD_FULL_RUNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mesh.reset_counts()
        t0 = time.perf_counter()
        state = eng.materialise_state(facts, program)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        missing = [k for k in REW_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"sharded run: kernels never launched: {missing}")
        st = state.stats
        runs.append(dict(
            wall_s=wall, rounds=st.rounds, launches=launches,
            collectives=mesh.counts(), capacity_retries=st.capacity_retries,
            rows_here=int(state.n_used.sum()), route_cap=eng.route_cap,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            split=split_summary(eng.last_split)))
        # every run, the reruns at the caps the first one grew included
        tag = f"world {world} run {i}"
        tri, rep = eng.state_triples(state), eng.state_rep(state)
        if not np.array_equal(rep, np.load(spec["rho"])):
            raise AssertionError(f"{tag}: rho differs from unsharded")
        if not np.array_equal(np.sort(pack(tri)), np.load(spec["keys"])):
            raise AssertionError(f"{tag}: triples differ from unsharded")
        counters = {k: getattr(st, k) for k in COUNTERS}
        if counters != spec["counters"]:
            raise AssertionError(f"{tag}: counters {counters} != "
                                 f"{spec['counters']}")
        del state, tri, rep
    return dict(runs=runs, route_cap_start=route_cap, route_cap=eng.route_cap,
                graphs=eng.last_split["graphs"],
                graphs_reason=eng.last_split.get("graphs_reason"))


def _shard_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of a phase-9 spawn: its device, its meshes, (a) and/or
    (b)/(c); its record goes to ``rank<r>.json`` beside ``spec_path``."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    from repro_torch.launch.mesh import make_engine_mesh

    device = _shard_device(spec["backend"], rank)
    torch.cuda.set_device(torch.device(device))
    mesh = make_engine_mesh(timeout_s=SHARD_TIMEOUT_S)
    cpu_mesh = (mesh if spec["backend"] == "gloo" else
                make_engine_mesh(backend="gloo", timeout_s=SHARD_TIMEOUT_S))
    out = dict(rank=rank, world=world, backend=spec["backend"], device=device)
    if spec["mid"]:
        out["mid"] = _shard_mid(rank, world, mesh, cpu_mesh, device)
    if spec["full"]:
        out["full"] = _shard_full(rank, world, mesh, device, spec)
    Path(spec_path).with_name(f"rank{rank}.json").write_text(json.dumps(out))


def sharded_phase(records: dict, kg: dict) -> None:
    """Phase 9: the sharded engine on ``torch.distributed``, one process a
    rank (spawned; the kernels were built by this process).  (a) mid size
    at world 1 on NCCL and world 2 on the one card through gloo; (b) full
    size at world 1 on NCCL; (c) full size at world 2 through gloo (which
    carries CUDA tensors itself); on a machine with more cards, full size
    at world = their count on NCCL."""
    from repro_torch.core.triples import pack
    from repro_torch.launch.mesh import spawn

    work = ROOT / "build" / "sharded"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    np.save(work / "facts.npy", kg["facts"])
    np.save(work / "rho.npy", kg["rho"])
    np.save(work / "keys.npy", np.sort(pack(kg["triples"])))
    with open(work / "program.pkl", "wb") as f:
        pickle.dump(kg["program"], f)
    full = records["fullsize"]
    shared = dict(facts=str(work / "facts.npy"), rho=str(work / "rho.npy"),
                  keys=str(work / "keys.npy"), program=str(work / "program.pkl"),
                  n_res=int(kg["dic"].n_resources), counters=kg["counters"])
    worlds = [("world1_nccl", 1, "nccl", True), ("world2_gloo", 2, "gloo", True)]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        worlds.append((f"world{n_cards}_nccl", n_cards, "nccl", False))
    out = {"card": card_line(), "unsharded_fused_rerun_wall_s":
           full["repeat_wall_s"]}
    for label, world, backend, mid in worlds:
        d = work / label
        d.mkdir()
        spec = dict(shared, backend=backend, mid=mid, full=True)
        with open(d / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        t0 = time.perf_counter()
        spawn(_shard_rank, world, (str(d / "spec.pkl"),), backend=backend,
              store_path=str(d / "store"), timeout_s=SHARD_TIMEOUT_S)
        ranks = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(world)]
        out[label] = dict(wall_s=time.perf_counter() - t0, ranks=ranks)
        for r in ranks:
            if "mid" in r:
                print(f"  {label} rank {r['rank']}: mid size, card == cpu per "
                      f"rank, gathered == unsharded after each step: "
                      f"{json.dumps(r['mid'])}", flush=True)
            runs = r["full"]["runs"]
            print(f"  {label} rank {r['rank']}: full size == unsharded after "
                  f"every run; route_cap {r['full']['route_cap_start']} -> "
                  f"{r['full']['route_cap']}; walls "
                  f"{[x['wall_s'] for x in runs]} s, restarts "
                  f"{[x['capacity_retries'] for x in runs]}, rounds {runs[0]['rounds']}, "
                  f"launches {json.dumps(runs[0]['launches'])}, collectives "
                  f"{json.dumps(runs[0]['collectives'])}, peak allocated "
                  f"{runs[0]['max_memory_allocated']} B", flush=True)
    print(f"  unsharded fused reruns (phase 5): {full['repeat_wall_s']} s",
          flush=True)
    records["sharded"] = out


# phase 10: training on the card
TRAIN_SEEDS, TRAIN_FANOUT = 1024, (15, 10)  # minibatch_lg's geometry
TRAIN_STEPS, TRAIN_KILL, TRAIN_CKPT_EVERY = 40, 17, 10
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCHES = 2, 3
TRAIN_SMALL_STEPS = 5
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 1024
# (e): one data rank's share of train_4k (16 x 4,096 tokens), counted on
# the host and measured in a process of its own by tools/lm_train_peak.py;
# beside it the same tool's reading on the parent tree (the commit before
# the chunk recompute and the sequence-parallel residuals; H100 80GB HBM3
# at 700 W, PERF.md)
LM_PEAK_BATCH, LM_PEAK_SEQ, LM_PEAK_STEPS = 16, 4096, 3
LM_PEAK_PARENT = dict(max_memory_allocated=45_862_305_792, layers_backward_peak=33_667_042_816)
LM_PEAK_CHUNK = 16  # the reduced card == CPU check: 4 KV chunks of 16 keys
# its gradients: bf16 activations, whose products cuBLAS and the CPU round
# at other places (one bf16 unit is 2^-8 = 3.9e-3 of a value), so
# TRAIN_GRAD_TOL's 1e-3 cannot hold.  tools/lm_grad_gap.py on an H100 80GB
# HBM3 at 700 W: 9.74e-3 of a leaf's largest at this seed, 9.7e-3 to
# 1.99e-2 over 4 seeds, the card's gradients bit for bit those of the tree
# before the chunk recompute (and the same gaps with the parameters cast to
# f32: the activations stay bf16); the limit is the largest of them (the
# loss 1.2e-5 at this seed, held to TRAIN_LOSS_RTOL)
LM_GRAD_TOL = 2e-2
# each peak must stay under this share of the parent's: the layers'
# backward (15.38 of 33.67 GB measured), where a chunk recompute that kept
# a chunk's blocks, or a layer's tensor, to the backward would come back
# above it, and the whole step (32.98 of 45.86 GB), which the loss head's
# f32 logits set: one more (B, S, V) block live would come back above it
LM_PEAK_SHARE = dict(max_memory_allocated=0.85, layers_backward_peak=0.6)
LM_PEAK_TIMEOUT_S = 600.0
# card against CPU, one loss and gradient: f32 sums in other orders (the
# segment sums' plan order against index_add_, cuBLAS against the CPU's
# products); the loss within TRAIN_LOSS_RTOL, each gradient leaf within
# TRAIN_GRAD_TOL of its largest CPU value.  On an H100 80GB HBM3 at 700 W:
# the loss 1.2e-7 relative at most but DimeNet's, 8.75e-5 (its energies
# reach ~4e3 through six residual blocks, its loss ~1.8e7, and f32 keeps
# few of their bits); gradients 1.8e-4 of a leaf's largest at most
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_TOL = 1e-3
# PNA's max and min pick one message a (node, feature); at a near tie the
# card and the CPU can pick different ones, which moves that gradient to
# another edge (on an H100: 31 of a leaf's 11,250 entries, up to 3.8e-3 of
# its largest value, at 2 layers on 2,000 nodes): its leaves are held by
# their relative L2 error instead
TRAIN_GRAD_L2_TOL = 1e-3


def grad_step(loss_fn, params, batch):
    """The loss and gradient leaves (zeros where unused) of
    ``loss_fn(params, batch)``, as a Trainer step takes them."""
    from torch.utils import _pytree as pytree

    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def card_vs_cpu_grads(label: str, loss_fn, params, batches: list,
                      ties: bool = False, grad_tol: float = TRAIN_GRAD_TOL) -> dict:
    """One loss and gradient of ``params`` (on the CPU) on each of
    ``batches`` (dicts of numpy arrays or tensors), on the card and on the
    CPU: every value finite, the loss and each leaf within the limits
    (``grad_tol`` of the leaf's largest value; with ``ties``, each leaf's
    relative L2 error within ``TRAIN_GRAD_L2_TOL``; its largest error is
    recorded beside)."""
    from repro_torch.data.graphs import graph_to

    card_params = _tree_to(params, "cuda")
    loss_err = grad_err = l2_err = 0.0
    for batch in batches:
        loss, grads = grad_step(loss_fn, card_params, graph_to(batch, "cuda"))
        host_loss, host_grads = grad_step(loss_fn, params, graph_to(batch, "cpu"))
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"{label}: a non-finite loss or gradient on the card")
        loss_err = max(loss_err, abs(float(loss) - float(host_loss))
                       / max(abs(float(host_loss)), 1e-30))
        for g, h in zip(grads, host_grads):
            scale = float(h.abs().max())
            if scale > 0:
                diff = g.cpu() - h
                grad_err = max(grad_err, float(diff.abs().max()) / scale)
                l2_err = max(l2_err, float(diff.norm()) / float(h.norm()))
    print(f"  {label}: card vs cpu, {len(batches)} batch(es): loss rel err "
          f"{loss_err:.3g} (limit {TRAIN_LOSS_RTOL}), gradient err {grad_err:.3g} of "
          f"a leaf's largest (limit {'none' if ties else grad_tol}), relative L2 "
          f"{l2_err:.3g} (limit {TRAIN_GRAD_L2_TOL if ties else 'none'})", flush=True)
    grads_ok = l2_err <= TRAIN_GRAD_L2_TOL if ties else grad_err <= grad_tol
    if not (loss_err <= TRAIN_LOSS_RTOL and grads_ok):
        raise AssertionError(f"{label}: card and CPU differ beyond the limits")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err, grad_l2_rel_err=l2_err,
                held_by="l2" if ties else "max", batches=len(batches),
                nonzero_grads=[bool(h.abs().max() > 0) for h in host_grads])


def train_run(loss_fn, params, batch_fn, steps: int, ckpt_dir: Path, *,
              until: int | None = None, resume: bool = False, async_ckpt: bool = True):
    """A Trainer from ``params`` (or resumed from ``ckpt_dir``) run to
    ``until`` (default ``steps``), closed."""
    from repro_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(n_steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_CKPT_EVERY,
                      keep=2, async_ckpt=async_ckpt, log_every=0)
    trainer = Trainer(loss_fn, params, batch_fn, cfg)
    if resume and not trainer.resume():
        raise AssertionError(f"no checkpoint to resume from in {ckpt_dir}")
    try:
        trainer.run(until)
    finally:
        trainer.close()
    return trainer


def same_tree(a, b) -> bool:
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def wall_stats(walls: list, edges: int | None = None) -> dict:
    """Median, min and max of a run's step walls, and steps (and edges)
    a second at the median."""
    med = statistics.median(walls)
    out = dict(step_wall_s=med, step_wall_min_s=min(walls), step_wall_max_s=max(walls),
               steps_per_s=1.0 / med)
    if edges is not None:
        out["edges_per_s"] = edges / med
    return out


def kg_minibatches(kg: dict):
    """Phase 8's sameAs-deduplicated KG made undirected (each edge both
    ways, duplicates dropped) and cut to the nodes that have an edge,
    renumbered, so that every node has an in-edge (the sampler's clamp of
    isolated nodes never acts); a 16-wide feature a node and a label in
    [0, 40) that a fixed projection of the feature decides (seeded, on the
    card); and ``batch_fn(step)``: ``NeighborSampler`` at ``minibatch_lg``'s
    geometry from seeds drawn by a generator seeded by the step, the loss
    on the seeds (``train_mask``)."""
    from repro_torch.data.sampler import NeighborSampler

    ei = kg["dedup_edge_index"].astype(np.int64)
    keys = np.unique(np.concatenate([(ei[0] << 32) | ei[1], (ei[1] << 32) | ei[0]]))
    src, dst = keys >> 32, keys & 0xFFFFFFFF
    live = np.unique(src)  # every edge goes both ways: src covers the nodes
    remap = np.full(kg["dic"].n_resources, -1, np.int64)
    remap[live] = np.arange(live.shape[0])
    edge_index = np.stack([remap[src], remap[dst]]).astype(np.int32)
    n = int(live.shape[0])
    sampler = NeighborSampler(n, edge_index)
    if not (np.diff(sampler.indptr) > 0).all():
        raise AssertionError("the undirected KG graph has a node without an in-edge")
    gen = torch.Generator(device="cuda").manual_seed(0)
    feat = torch.randn((n, 16), generator=gen, device="cuda")
    labels = (feat @ torch.randn((16, 40), generator=gen, device="cuda")).argmax(1)
    labels = labels.to(torch.int32)
    sample_s: list = []

    def batch_fn(step: int) -> dict:
        t0 = time.perf_counter()
        rng = np.random.default_rng(1_000_000 + step)
        seeds = rng.choice(n, TRAIN_SEEDS, replace=False)
        nodes, sub_ei, seed_pos = sampler.sample(rng, seeds, TRAIN_FANOUT)
        nodes = torch.from_numpy(nodes).to("cuda").long()
        mask = torch.zeros(nodes.shape[0], device="cuda")
        mask[torch.from_numpy(seed_pos).to("cuda").long()] = 1.0
        batch = {"x": feat[nodes], "edge_index": torch.from_numpy(sub_ei).to("cuda"),
                 "edge_attr": torch.ones((sub_ei.shape[1], 1), device="cuda"),
                 "labels": labels[nodes], "train_mask": mask}
        sample_s.append(time.perf_counter() - t0)
        return batch

    info = dict(nodes=n, undirected_edges=int(edge_index.shape[1]),
                dedup_edges=int(ei.shape[1]))
    return batch_fn, sample_s, info


def train_kernel_checks(ops, ref, records: dict, batch: dict, later_batches: dict) -> None:
    """The segment sum against its plain version at the shapes training
    gives it: the main path's backward of ``x[dst]`` (the minibatch's
    168,960 rows of 70 into its 169,984 nodes), EGNN's position update (K
    3) and DimeNet's triplet sum by ``t_out`` (32,768 rows of 128 into the
    8,192 edges), each with its plan."""
    record = recorder(records)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [("main path backward: minibatch x[dst]", batch["edge_index"][1],
              int(batch["x"].shape[0]), 70)]
    mol = later_batches["molecule"]
    dst = torch.from_numpy(mol["edge_index"][1]).to("cuda")
    t_out = torch.from_numpy(mol["triplets"][1]).to("cuda")
    cases += [("EGNN position update (molecule)", dst, int(mol["z"].shape[0]), 3),
              ("DimeNet triplets by t_out (molecule)", t_out,
               int(mol["edge_index"].shape[1]), 128)]
    for label, seg, n, k in cases:
        e = seg.shape[0]
        x = torch.randn(e, k, generator=gen, device="cuda")
        plan = ops.segment_plan(seg, n)
        got = ops.segment_sum(x, seg, n, plan)
        if not torch.equal(got, ops.segment_sum(x, seg, n, plan)):
            raise AssertionError(f"segment_sum {label}: two calls differ")
        err, tol = _sum_err(got, ref.segment_sum(x, seg, n),
                            ref.segment_sum(x.abs(), seg, n))
        idx = seg.to(torch.int64)
        record("segment_sum", f"training, {label}: E={e}, n={n}, K={k} float32", err,
               time_ms(lambda: ops.segment_sum(x, seg, n, plan)),
               time_ms(lambda: ref.segment_sum(x, seg, n)),
               time_ms(lambda: torch.zeros((n, k), device="cuda").index_add_(0, idx, x)),
               counts("segment_sum", x, seg, n), tol=tol)


def lm_peak_tool(*args: str) -> list:
    """The command of ``tools/lm_train_peak.py`` on this tree at (e)'s
    batch and sequence, with ``args``."""
    return [sys.executable, str(ROOT / "tools" / "lm_train_peak.py"), "--src", str(ROOT),
            "--batch", str(LM_PEAK_BATCH), "--seq", str(LM_PEAK_SEQ), *args]


def lm_peak_count_start() -> subprocess.Popen:
    """Phase 10 (e)'s dry-run count, started on the host (no card) at the
    start, beside the build; :func:`lm_peak_phase` waits for it."""
    return subprocess.Popen(lm_peak_tool("--count"), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def lm_peak_phase(lm_count: subprocess.Popen) -> dict:
    """Phase 10 (e): SmolLM-135M whole at 16 x 4,096 tokens, 3 steps in a
    process of its own, beside the dry run's count and the parent's
    peak; first the reduced config at 4 KV chunks, card against CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import transformer as lm

    cfg = dataclasses.replace(get_arch("smollm-135m").reduced, attn_chunk=LM_PEAK_CHUNK)
    host = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check = card_vs_cpu_grads(
        f"SmolLM reduced, 4 KV chunks of {LM_PEAK_CHUNK}",
        lambda p, b: lm.loss_fn(p, cfg, b["tokens"], b["labels"]), host,
        [lm_batch(s, 2, 4 * LM_PEAK_CHUNK, cfg.vocab) for s in range(2)],
        grad_tol=LM_GRAD_TOL)
    _free_card()
    t0 = time.perf_counter()
    run = subprocess.run(lm_peak_tool("--measure", "--steps", str(LM_PEAK_STEPS)),
                         capture_output=True, text=True, timeout=LM_PEAK_TIMEOUT_S)
    if run.returncode:
        raise AssertionError(f"(e) the SmolLM train_4k step failed: {run.stderr[-3000:]}")
    got = _last_json(run.stdout)
    got["process_s"] = time.perf_counter() - t0
    out, err = lm_count.communicate(timeout=LM_PEAK_TIMEOUT_S)
    if lm_count.returncode:
        raise AssertionError(f"(e) the dry run's count failed: {err[-3000:]}")
    dry = _last_json(out)["dryrun_peak_bytes"]
    if not all(np.isfinite(got["losses"])):
        raise AssertionError(f"(e) SmolLM train_4k: a non-finite loss {got['losses']}")
    layers = max(got["layers_backward_peaks"])
    for key, peak in (("max_memory_allocated", got["max_memory_allocated"]),
                      ("layers_backward_peak", layers)):
        if peak > LM_PEAK_SHARE[key] * LM_PEAK_PARENT[key]:
            raise AssertionError(f"(e) SmolLM train_4k: {key} {peak} B, over "
                                 f"{LM_PEAK_SHARE[key]} of the parent's {LM_PEAK_PARENT[key]} B")
    print(f"  (e) SmolLM-135M, 30 layers, {LM_PEAK_BATCH} x {LM_PEAK_SEQ} tokens, "
          f"{LM_PEAK_STEPS} steps: walls {[round(x, 3) for x in got['step_walls_s']]} s, "
          f"losses {[round(x, 4) for x in got['losses']]}; peak max_memory_allocated "
          f"{got['max_memory_allocated']} B (the dry run's count at a (1, 1) mesh "
          f"{dry} B; the parent's measured {LM_PEAK_PARENT['max_memory_allocated']} B); "
          f"the backward through the layers {layers} B (the parent's "
          f"{LM_PEAK_PARENT['layers_backward_peak']} B); forward and loss head "
          f"{max(got['head_peaks'])} B", flush=True)
    return dict(got, dryrun_peak_bytes=dry, parent=LM_PEAK_PARENT, card_vs_cpu=check,
                config="smollm-135m", batch=LM_PEAK_BATCH, seq=LM_PEAK_SEQ)


EXAMPLES = ("quickstart", "materialise_kg", "serve_sparql", "serve_lm", "train_lm",
            "kg_dedup_gnn")
EXAMPLE_LINES = 6  # of each example's output, printed


def _example(name: str, args: list) -> tuple[float, list]:
    """Run ``repro_torch.examples.<name>``'s main: (wall, printed lines)."""
    import importlib
    import io

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, buf.getvalue().splitlines()


def examples_phase(records: dict) -> None:
    """Phase 10b: the six examples on the card at their defaults
    (``train_lm`` at 20 steps); ``quickstart`` equal to its CPU run."""
    work = ROOT / "build" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    out = {}
    for name in EXAMPLES:
        args = ["--steps", "20", "--ckpt-dir", str(work / "train_lm")] if name == "train_lm" \
            else []
        wall, lines = _example(name, args)
        out[name] = dict(wall_s=wall, lines=lines)
        print(f"  {name} ({wall:.2f} s):", flush=True)
        for line in lines[-EXAMPLE_LINES:]:
            print(f"    {line}", flush=True)
    _, host = _example("quickstart", ["--device", "cpu"])
    checks = {
        "quickstart == cpu": out["quickstart"]["lines"] == host,
        "quickstart Theorem 1(3)":
            out["quickstart"]["lines"][-1].endswith("|T^rho| = 21 == |AX| = 21: True"),
        "materialise_kg Theorem 1": any(line.startswith("Theorem 1 validated")
                                        for line in out["materialise_kg"]["lines"]),
        "train_lm finite": bool(np.isfinite(float(out["train_lm"]["lines"][-1].split()[2]))),
        "kg_dedup_gnn edges": any(line.startswith("dedup graph: 4891 edges")
                                  for line in out["kg_dedup_gnn"]["lines"]),
    }
    total = sum(x["wall_s"] for x in out.values())
    print(f"  the six examples in {total:.1f} s; {json.dumps(checks)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"examples: {checks}")
    shutil.rmtree(work, ignore_errors=True)
    records["examples"] = dict(out, checks=checks, total_s=total)


def training_phase(ops, ref, records: dict, kg: dict, later: list,
                   lm_count: subprocess.Popen) -> int:
    """Phase 10; returns the segment sum's launches on its main path (the
    uninterrupted 40-step run of (a))."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batch, molecule_batch, random_graph, recsys_batch
    from repro_torch.models import recsys, transformer as lm
    from repro_torch.models.gnn import dimenet, egnn, gatedgcn, pna
    from repro_torch.optim import adamw_init, adamw_update

    work = ROOT / "build" / "train_ckpt"
    if work.exists():
        shutil.rmtree(work)
    out: dict = {"card": card_line()}

    # (a) the main path: GatedGCN at full width on KG minibatches
    t0 = time.perf_counter()
    batch_fn, sample_s, info = kg_minibatches(kg)
    info["prep_s"] = time.perf_counter() - t0
    cfg = dataclasses.replace(get_arch("gatedgcn").config, d_in=16)

    def loss_fn(p, b):
        return gatedgcn.loss_fn(p, cfg, b)

    params = gatedgcn.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    first = batch_fn(0)
    info.update(sub_nodes=int(first["x"].shape[0]),
                sub_edges=int(first["edge_index"].shape[1]))
    mol0 = molecule_batch(np.random.default_rng(0), 128, 30, 64)
    train_kernel_checks(ops, ref, records["kernels"], first, {"molecule": mol0})
    grad_step(loss_fn, params, first)  # first-call costs, outside the count
    del first, mol0
    sample_s.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    full = train_run(loss_fn, params, batch_fn, TRAIN_STEPS, work / "a")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict(segment_sum=64 * TRAIN_STEPS, dedup_order=2 * TRAIN_STEPS,
                search_bounds=2 * TRAIN_STEPS)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    if not all(np.isfinite(full.losses)):
        raise AssertionError("training: a non-finite loss")
    walls, samples = list(full.step_walls), list(sample_s)
    fb = batch_fn(0)
    ops.reset_launches()
    with torch.no_grad():
        loss_fn(full.params, fb)
    torch.cuda.synchronize()
    forward_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    per_step = {k: v // TRAIN_STEPS for k, v in launches.items() if v}
    backward_launches = {k: per_step[k] - forward_launches.get(k, 0) for k in per_step
                         if per_step[k] != forward_launches.get(k, 0)}
    if forward_launches != dict(segment_sum=2 * cfg.n_layers, dedup_order=2,
                                search_bounds=2) or \
            backward_launches != dict(segment_sum=2 * cfg.n_layers):
        raise AssertionError(f"a step's launches: forward {forward_launches}, "
                             f"backward {backward_launches}")
    del fb
    # killed after step 17 (checkpoints at 10 and 17), then resumed
    cut = train_run(loss_fn, params, batch_fn, TRAIN_STEPS, work / "b", until=TRAIN_KILL)
    resumed = train_run(loss_fn, params, batch_fn, TRAIN_STEPS, work / "b", resume=True)
    if cut.losses + resumed.losses != full.losses:
        raise AssertionError("the killed and resumed run's losses differ from the "
                             "uninterrupted run's")
    if not (same_tree(resumed.params, full.params) and same_tree(resumed.opt, full.opt)):
        raise AssertionError("the resumed run's parameters differ from the "
                             "uninterrupted run's")
    print(f"  killed after step {TRAIN_KILL} and resumed: {TRAIN_STEPS - TRAIN_KILL} "
          f"losses and every parameter and moment bit-identical", flush=True)
    cpu_cfg = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    cpu_params = gatedgcn.init_params(torch.Generator().manual_seed(0), cpu_cfg, device="cpu")
    check = card_vs_cpu_grads(
        f"GatedGCN {TRAIN_CHECK_LAYERS} layers, KG minibatches",
        lambda p, b: gatedgcn.loss_fn(p, cpu_cfg, b), cpu_params,
        [{k: v.cpu() for k, v in batch_fn(s).items()} for s in range(TRAIN_CHECK_BATCHES)])
    out["main"] = dict(
        config=cfg.name, n_layers=cfg.n_layers, d_hidden=cfg.d_hidden, d_in=cfg.d_in,
        n_classes=cfg.n_classes, seeds=TRAIN_SEEDS, fanout=list(TRAIN_FANOUT),
        steps=TRAIN_STEPS, **info, **wall_stats(walls, info["sub_edges"]),
        walls_s=walls, sample_s_median=statistics.median(samples),
        losses=full.losses, max_memory_allocated=peak, launches=launches,
        launches_per_step=per_step, launches_forward=forward_launches,
        launches_backward=backward_launches, kill_after=TRAIN_KILL, resumed_bit_identical=True,
        card_vs_cpu=check)
    print(f"  GatedGCN {cfg.n_layers} layers on KG minibatches ({info['sub_nodes']} "
          f"nodes, {info['sub_edges']} edges): {TRAIN_STEPS} steps, median step "
          f"{out['main']['step_wall_s'] * 1e3:.1f} ms (sampling "
          f"{out['main']['sample_s_median'] * 1e3:.1f} ms), "
          f"{out['main']['edges_per_s']:.4g} edges/s, loss {full.losses[0]:.4f} -> "
          f"{full.losses[-1]:.4f}, peak {peak} B, launches a step "
          f"{json.dumps(per_step)}", flush=True)

    def profile_step(rec=out["main"]):
        """One training step (loss, gradients, AdamW) and its forward alone
        under torch.profiler, on a batch and parameters made anew: the
        segment sum's device time forward and backward, and its share."""
        p = gatedgcn.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        b = batch_fn(0)
        opt = adamw_init(p)

        def step():
            from torch.utils import _pytree as pytree

            _, grads = grad_step(loss_fn, p, b)
            return adamw_update(p, pytree.tree_unflatten(grads, pytree.tree_structure(p)),
                                opt)

        def forward():
            with torch.no_grad():
                return loss_fn(p, b)

        prof, wall, _ = profiled(step)
        busy = device_time(prof, wall)
        prof, fwall, _ = profiled(forward)
        fwd = device_time(prof, fwall)
        seg_all = busy["port_kernels_ms"].get("segment_sum", 0.0)
        seg_fwd = fwd["port_kernels_ms"].get("segment_sum", 0.0)
        busy.update(segment_sum_forward_ms=seg_fwd, segment_sum_backward_ms=seg_all - seg_fwd,
                    segment_sum_forward_share=seg_fwd / busy["busy_ms"],
                    segment_sum_backward_share=(seg_all - seg_fwd) / busy["busy_ms"],
                    forward_alone=fwd)
        rec["profiled_step_wall_s"], rec["profiled_step"] = wall, busy
        print(f"  profiled GatedGCN training step: {wall * 1e3:.1f} ms, busy "
              f"{busy['busy_ms']:.2f} ms; segment_sum forward {seg_fwd:.3f} ms "
              f"({busy['segment_sum_forward_share']:.1%}), backward "
              f"{seg_all - seg_fwd:.3f} ms ({busy['segment_sum_backward_share']:.1%})",
              flush=True)

    later.append(profile_step)
    del full, cut, resumed, params

    # (b) EGNN and DimeNet on the molecule shape, GatedGCN and PNA on
    # full_graph_sm, at their configs
    out["small"] = {}
    for name, mod in (("egnn", egnn), ("dimenet", dimenet), ("gatedgcn", gatedgcn),
                      ("pna", pna)):
        spec = get_arch(name)
        mcfg = spec.config
        if name in ("egnn", "dimenet"):
            dims = spec.shape("molecule").dims

            def fn(step, dims=dims):
                return molecule_batch(np.random.default_rng(step), dims["batch"],
                                      dims["n_nodes"], dims["n_edges"])
        else:
            dims = spec.shape("full_graph_sm").dims
            graph = random_graph(np.random.default_rng(0), dims["n_nodes"],
                                 dims["n_edges"], dims["d_feat"], mcfg.n_classes)

            def fn(step, graph=graph):
                return graph

        def mloss(p, b, mod=mod, mcfg=mcfg):
            return mod.loss_fn(p, mcfg, b)

        host = mod.init_params(torch.Generator().manual_seed(0), mcfg, device="cpu")
        check = card_vs_cpu_grads(f"{name} first step", mloss, host, [fn(0)],
                                  ties=name == "pna")
        init = _tree_to(host, "cuda")
        torch.cuda.reset_peak_memory_stats()
        runs = [train_run(mloss, init, fn, TRAIN_SMALL_STEPS, work / f"{name}{i}")
                for i in range(2)]
        peak = torch.cuda.max_memory_allocated()
        from torch.utils import _pytree as pytree

        moved = [not torch.equal(a, b) for a, b in zip(pytree.tree_leaves(runs[0].params),
                                                       pytree.tree_leaves(init))]
        if not all(np.isfinite(runs[0].losses)) or not all(
                m for m, g in zip(moved, check["nonzero_grads"]) if g):
            raise AssertionError(f"{name}: a non-finite loss or a parameter with a "
                                 "gradient that did not move")
        bit_equal = runs[0].losses == runs[1].losses and same_tree(runs[0].params,
                                                                    runs[1].params)
        if not bit_equal and name != "pna":
            raise AssertionError(f"{name}: two card runs differ")
        e = fn(0)["edge_index"].shape[1]
        out["small"][name] = dict(
            config=mcfg.name, shape=dims, steps=TRAIN_SMALL_STEPS, losses=runs[0].losses,
            **wall_stats(runs[0].step_walls[1:], e), walls_s=runs[0].step_walls,
            max_memory_allocated=peak, moved_leaves=sum(moved), leaves=len(moved),
            two_runs_bit_equal=bit_equal, card_vs_cpu=check)
        print(f"  {name} ({mcfg.name}): {TRAIN_SMALL_STEPS} steps, losses "
              f"{[round(x, 4) for x in runs[0].losses]}, median step "
              f"{out['small'][name]['step_wall_s'] * 1e3:.1f} ms, two card runs "
              f"bit-equal: {bit_equal}", flush=True)
        del runs, init

    # (c) SmolLM-135M at full width, remat on; (d) the Criteo-scale FM
    lcfg = get_arch("smollm-135m").config
    fcfg = dataclasses.replace(get_arch("fm").config, use_pallas=False)
    for label, make, fn, mloss in (
        ("smollm_135m", lambda: lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                               lcfg),
         lambda step: lm_batch(step, LM_TRAIN_BATCH, LM_TRAIN_SEQ, lcfg.vocab),
         lambda p, b: lm.loss_fn(p, lcfg, b["tokens"], b["labels"])),
        ("fm_criteo", lambda: recsys.init_params(torch.Generator(device="cuda").manual_seed(0),
                                                 fcfg),
         lambda step: recsys_batch(step, get_arch("fm").shape("train_batch").dims["batch"],
                                   fcfg.n_fields, fcfg.rows_per_field),
         lambda p, b: recsys.loss_fn(p, fcfg, b)),
    ):
        init = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for i in range(2):
            runs.append(train_run(mloss, init, fn, TRAIN_SMALL_STEPS, work / f"{label}{i}",
                                  async_ckpt=False))
            shutil.rmtree(work / f"{label}{i}")
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(runs[0].losses)):
            raise AssertionError(f"{label}: a non-finite loss")
        bit_equal = runs[0].losses == runs[1].losses and same_tree(runs[0].params,
                                                                    runs[1].params)
        out[label] = dict(steps=TRAIN_SMALL_STEPS, losses=runs[0].losses,
                          **wall_stats(runs[0].step_walls[1:]), walls_s=runs[0].step_walls,
                          max_memory_allocated=peak, two_runs_bit_equal=bit_equal)
        print(f"  {label}: {TRAIN_SMALL_STEPS} steps, losses "
              f"{[round(x, 4) for x in runs[0].losses]}, median step "
              f"{out[label]['step_wall_s'] * 1e3:.1f} ms, peak {peak} B, two runs "
              f"bit-equal: {bit_equal}", flush=True)
        del runs, init
        _free_card()
    out["lm_config"] = dict(name=lcfg.name, n_layers=lcfg.n_layers, batch=LM_TRAIN_BATCH,
                            seq=LM_TRAIN_SEQ, remat=lcfg.remat, attn_impl=lcfg.attn_impl)
    out["smollm_135m_train_4k"] = lm_peak_phase(lm_count)
    out["fm_config"] = dict(name=fcfg.name, n_rows=fcfg.n_rows, use_pallas=fcfg.use_pallas)
    shutil.rmtree(work)
    records["training"] = out
    return launches["segment_sum"]


# phase 11: sharded training on torch.distributed (one spawned process a rank)
SHT_TIMEOUT_S = 600.0
SHT_LM_STEPS, SHT_LM_BATCH, SHT_LM_SEQ, SHT_LM_SAVE_AFTER = 3, 2, 1024, 2
# (a)'s depth cut 28 -> 8: at 28 layers its checkpoint (15.4 GB) took
# 52 s to save and 51 s to restore and phase 11 ran 300 s; at 14, 31 s and
# 22 s, and the whole script 1,076 s of its 1,200
SHT_LM_LAYERS = 8
SHT_MOE_LAYERS, SHT_MOE_STEPS, SHT_MOE_BATCH, SHT_MOE_SEQ = 2, 2, 2, 512
SHT_GNN_STEPS, SHT_FM_STEPS, SHT_E_LM_LAYERS = 10, 3, 2
SHT_EDGE_MULTIPLE = 512  # the reference's GNN cells pad their edges so
# sharded against unsharded on the card, relative: about 10x the largest
# gap read on an H100 over three runs of this phase (bf16 LMs, their
# tensor-parallel sums in another order: loss 5.7e-5, norm 7.3e-4; f32
# GNN and FM sums in another order: loss 1.1e-7, norm 1.5e-7)
SHT_TOL = {"bf16": dict(loss=5e-4, gn=1e-2), "f32": dict(loss=1e-6, gn=2e-6)}
SHT_MOE_TIE = 0.05  # a token's K-th and (K+1)-th probabilities this close tie
# of a layer's tokens: with random weights the K-th and (K+1)-th of 64
# experts tie within 1 % for about 8 % of the tokens, and the sharded
# sums' bf16 rounding flips some of them (up to 86 of 1,024 in a layer on
# an H100)
SHT_MOE_MAX_FLIPS = 0.10


def _sht_lm_spec(name: str, n_layers: int | None, batch: int, seq: int):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec

    spec = get_arch(name)
    if n_layers is not None:
        spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config,
                                                                    n_layers=n_layers))
    return spec, ShapeSpec(f"train_{batch}x{seq}", "train",
                           dict(global_batch=batch, seq_len=seq))


def _sht_spec(job: dict):
    """(ArchSpec, ShapeSpec) of a phase-11 job."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec

    if job["family"] == "lm":
        return _sht_lm_spec(job["arch"], job.get("n_layers"), job["batch"], job["seq"])
    if job["family"] == "gnn":
        spec = get_arch("gatedgcn")
        return spec, ShapeSpec("minibatch_sampled", "train",
                               dict(n_nodes=job["nodes"], n_edges=job["edges"], d_feat=16))
    spec = get_arch("fm")
    return spec, spec.shape("train_batch")


def _sht_params(job: dict, cfg, device):
    """The job's global weights, seeded on the card (every rank and the
    yardstick draw the same)."""
    from repro_torch.models import recsys, transformer as lm
    from repro_torch.models.gnn import gatedgcn

    gen = torch.Generator(device="cuda").manual_seed(0)
    if job["family"] == "lm":
        params = lm.init_params(gen, cfg, device)
        if cfg.is_moe:  # a seeded non-zero router (the reference's is zeros)
            r = params["layers"]["router"]
            params["layers"]["router"] = torch.randn(r.shape, generator=gen, device=gen.device,
                                                     dtype=r.dtype).to(device) * 0.02
        return params
    if job["family"] == "gnn":
        return gatedgcn.init_params(gen, dataclasses.replace(cfg, d_in=16), device)
    return recsys.init_params(gen, cfg, device)


def _sht_batch(job: dict, step: int, cfg) -> tuple:
    """The global batch of ``step`` (numpy), after (params, opt)."""
    from repro_torch.data.pipeline import lm_batch, recsys_batch

    if job["family"] == "lm":
        b = lm_batch(step, job["batch"], job["seq"], cfg.vocab)
        return b["tokens"], b["labels"]
    if job["family"] == "gnn":
        with np.load(Path(job["batches"]) / f"step{step}.npz") as z:
            return ({k: z[k] for k in z.files},)
    return (recsys_batch(step, job["batch"], cfg.n_fields, cfg.rows_per_field),)


def _sht_dry_collectives(job: dict, shape: tuple, axes: tuple) -> dict:
    """The dry run's count of a phase-11 job's step on a mesh of ``shape``
    (rank 0 of a fake group; every rank of an LM cell counts the same):
    its collectives as a rank's ``mesh.counts()`` and its peak."""
    from repro_torch.launch.dryrun import count_cell, fake_group
    from repro_torch.launch.mesh import make_mesh

    spec, sh = _sht_spec(job)
    with fake_group(int(np.prod(shape)), 0):
        rec = count_cell(spec, sh, make_mesh(shape, axes))
    by = rec["collectives"]["by_kind"]
    return dict(collectives=dict(calls={k: v["count"] for k, v in by.items()},
                                 bytes={k: v["bytes"] for k, v in by.items()}),
                peak_bytes=rec["memory"]["peak_bytes"])


def _sht_counts(mesh) -> dict:
    return mesh.counts() if mesh is not None else {}


def _digest(tree) -> str:
    from torch.utils import _pytree as pytree

    h = hashlib.sha256()
    for t in pytree.tree_leaves(tree):
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sht_steps(job: dict, mesh, device) -> dict:
    """A phase-11 job's steps: on this rank's blocks of the cell on ``mesh``
    (or the unsharded step where ``mesh`` is None), from the seeded weights
    or restored from ``job["restore"]`` (with ``job["save_after"]``, the
    state after that step saved); each step's loss, norm, wall, peak
    memory, collectives, launches and (MoE) routing; with
    ``job["replay"]``, each step's MoE calls routed to the given top k."""
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import place, shard_shape
    from repro_torch.launch.workloads import build_cell, value_and_grad
    from repro_torch.models import recsys, transformer as lm
    from repro_torch.models.gnn import gatedgcn
    from repro_torch.models.moe import RoutingLog, routing_log
    from repro_torch.optim import adamw_init, adamw_update

    t_init = time.perf_counter()
    spec, shape = _sht_spec(job)
    if mesh is not None:
        cell = build_cell(spec, shape, mesh)
        if job.get("restore"):  # blocks to restore into
            params = pytree.tree_map(
                lambda sd, sh: torch.empty(shard_shape(sd.shape, sh), dtype=sd.dtype,
                                           device=device),
                cell.input_specs[0], cell.in_shardings[0])
        else:
            full = _sht_params(job, spec.config, device)
            params = place(full, cell.in_shardings[0], device)
            del full
            torch.cuda.empty_cache()
        opt = cell.init_opt(device)
        shardings = {"params": cell.in_shardings[0], "opt": cell.in_shardings[1]}
        step_fn = cell.step
    else:
        cfg = spec.config
        if job["family"] == "lm" and cfg.is_moe:
            cfg = dataclasses.replace(cfg, n_token_shards=job["chunks"])
        if job["family"] == "gnn":
            cfg = dataclasses.replace(cfg, d_in=16)
        params = _sht_params(job, spec.config, device)
        opt = adamw_init(params)

        def loss(p, *batch):
            if job["family"] == "lm":
                return lm.loss_fn(p, cfg, *batch)
            if job["family"] == "gnn":
                return gatedgcn.loss_fn(p, cfg, batch[0])
            return recsys.loss_fn(p, cfg, batch[0])

        def step_fn(p, o, *batch):
            value, grads = value_and_grad(loss, p, *batch)
            with torch.no_grad():
                p, o, gn = adamw_update(p, grads, o)
            return p, o, value, gn

    first = 0
    if job.get("restore"):
        t0 = time.perf_counter()
        state, aux, _ = restore_checkpoint(job["restore"], {"params": params, "opt": opt},
                                           shardings=shardings)
        params, opt, first = state["params"], state["opt"], int(aux["next_step"])
        t_restore = time.perf_counter() - t0
    out = dict(steps=[], first_step=first, init_s=time.perf_counter() - t_init)
    if job.get("restore"):
        out["restore_s"] = t_restore
    for step in range(first, job["steps"]):
        batch = _sht_batch(job, step, spec.config)
        if mesh is not None:
            batch = [place(b, sh, device) for b, sh in zip(batch, cell.in_shardings[2:])]
        else:
            batch = [pytree.tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device), b)
                     for b in batch]
        replay = ([torch.as_tensor(np.asarray(t)) for t in job["replay"][step]]
                  if job.get("replay") else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        if mesh is not None:
            mesh.reset_counts()
        t0 = time.perf_counter()
        with routing_log(RoutingLog(keep_calls=job.get("routes", False),
                                    replay=replay)) as log:
            params, opt, loss_v, gn = step_fn(params, opt, *batch)
            loss_v, gn = float(loss_v), float(gn)
        torch.cuda.synchronize()
        rec = dict(step=step, loss=loss_v, gn=gn, wall_s=time.perf_counter() - t0,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches={k: v for k, v in ops.LAUNCHES.items() if v},
                   collectives=_sht_counts(mesh))
        if job.get("routes"):
            rec["routes"] = [dict(top=r["gate_idx"].tolist(), probs=r["probs"].tolist())
                             for r in log.routes]
        out["steps"].append(rec)
        del batch
        if job.get("save_after") == step + 1 and mesh is not None:
            t0 = time.perf_counter()
            save_checkpoint(job["ckpt"], step + 1, {"params": params, "opt": opt},
                            aux={"next_step": step + 1}, shardings=shardings)
            torch.distributed.barrier()  # rank 0's write before anyone reads it
            out["save_s"] = time.perf_counter() - t0
    out["digest"] = _digest(params) if mesh is None or mesh.size == 1 else None
    del params, opt
    torch.cuda.empty_cache()
    return out


def _sht_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of a phase-11 spawn: its device, every mesh of the spawn
    (``make_mesh`` is collective), then each job on its mesh where this
    rank is in it; its record goes to ``rank<r>.json`` beside
    ``spec_path``."""
    from repro_torch.launch.mesh import make_mesh

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    # cuBLAS reads this at its first call: (e)'s deterministic mode needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = _shard_device(spec["backend"], rank)
    torch.cuda.set_device(torch.device(device))
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = [make_mesh(shape, axes, timeout_s=SHT_TIMEOUT_S)
              for shape, axes in spec["meshes"]]
    out = dict(rank=rank, world=world, backend=spec["backend"], device=device, jobs={})
    if spec.get("world1"):  # (e): the unsharded step and the mesh of one, in turn
        torch.use_deterministic_algorithms(True)
        for job in spec["jobs"]:
            out["jobs"][job["label"]] = dict(unsharded=sht_steps(job, None, device),
                                             sharded=sht_steps(job, meshes[0], device))
        if spec.get("cells"):  # phase 12 (d)
            out["cells"] = cells_world1(spec["cells"], meshes[0], device)
    else:
        for job in spec["jobs"]:
            torch.distributed.barrier()  # each job starts on every rank at once
            mesh = meshes[job["mesh"]]
            if mesh is None:
                continue
            t0 = time.perf_counter()
            run = sht_steps(job, mesh, device)
            run.update(wall_s=time.perf_counter() - t0, coords=mesh.coords)
            out["jobs"][job["label"]] = run
            print(f"  rank {rank}: {job['label']} done in {run['wall_s']:.1f} s", flush=True)
        if spec.get("cells"):  # phase 12 (a)-(c), after the train cells
            torch.distributed.barrier()
            t0 = time.perf_counter()
            out["cells"] = cells_rank(spec["cells"], meshes[0], device)
            out["cells_wall_s"] = time.perf_counter() - t0
            print(f"  rank {rank}: phase 12 cells done in {out['cells_wall_s']:.1f} s", flush=True)
    Path(spec_path).with_name(f"rank{rank}.json").write_text(json.dumps(out))


def _sht_spawn(work: Path, label: str, world: int, backend: str, **spec) -> list:
    from repro_torch.launch.mesh import spawn

    d = work / label
    d.mkdir(parents=True)
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump(dict(spec, backend=backend), f)
    spawn(_sht_rank, world, (str(d / "spec.pkl"),), backend=backend,
          store_path=str(d / "store"), timeout_s=SHT_TIMEOUT_S)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def _sht_gaps(label: str, dtype: str, runs: list, want: list) -> list:
    """Each step's loss and norm against the yardstick's, beside the
    tolerance; raises beyond it."""
    tol = SHT_TOL[dtype]
    out = []
    for got, ref in zip(runs, want):
        g = {q: abs(got[q] - ref[q]) / max(abs(ref[q]), 1e-30) for q in ("loss", "gn")}
        out.append(dict(step=got["step"], loss_rel_gap=g["loss"], loss_tol=tol["loss"],
                        gn_rel_gap=g["gn"], gn_tol=tol["gn"]))
        print(f"  {label} step {got['step'] + 1}: loss {got['loss']:.6f} vs {ref['loss']:.6f} "
              f"(rel gap {g['loss']:.3g}, tolerance {tol['loss']}), norm {got['gn']:.5g} vs "
              f"{ref['gn']:.5g} (rel gap {g['gn']:.3g}, tolerance {tol['gn']})", flush=True)
        if not (g["loss"] <= tol["loss"] and g["gn"] <= tol["gn"]
                and np.isfinite(got["loss"])):
            raise AssertionError(f"{label} step {got['step'] + 1}: sharded and unsharded "
                                 "differ beyond the tolerance")
    return out


def _sht_print_ranks(label: str, runs: list) -> None:
    for r in runs:
        steps = r["steps"]
        extra = "".join(f", {k} {r[k]:.1f} s" for k in ("init_s", "save_s", "restore_s")
                        if k in r)
        print(f"  {label} rank {r['rank']} {r['coords']}: step walls "
              f"{[round(x['wall_s'], 3) for x in steps]} s{extra}, peak "
              f"{max(x['max_memory_allocated'] for x in steps)} B, collectives a step "
              f"{json.dumps(steps[-1]['collectives'])}, launches a step "
              f"{json.dumps(steps[-1]['launches'])}", flush=True)


def _sht_routes(runs: list) -> list:
    """Each step's routing of the sharded run: per layer the (C, Tl, K)
    top k and probabilities of the data ranks' chunks, in order."""
    data_ranks = sorted((r for r in runs if r["coords"]["model"] == 0),
                        key=lambda r: r["rank"])
    out = []
    for s in range(len(data_ranks[0]["steps"])):
        layers = []
        for layer in range(len(data_ranks[0]["steps"][s]["routes"])):
            layers.append({q: np.concatenate([np.asarray(r["steps"][s]["routes"][layer][q])
                                              for r in data_ranks]) for q in ("top", "probs")})
        out.append(layers)
    return out


def _sht_routing(label: str, sharded: list, replayed: dict) -> dict:
    """The sharded run's routing against the yardstick's router on the same
    inputs (the yardstick replaying the sharded run's routes, so that a
    flip does not cascade through capacity): the set of experts of each
    token as integers, a token differing only at a near tie of its K-th
    and (K+1)-th probabilities, at most SHT_MOE_MAX_FLIPS of them a layer."""
    flips, widest = [], 0.0
    for s, layers in enumerate(sharded):
        for layer, got in enumerate(layers):
            want = np.asarray(replayed["steps"][s]["routes"][layer]["top"])
            top, probs = got["top"], got["probs"]
            diff = np.argwhere((np.sort(top, -1) != np.sort(want, -1)).any(-1))
            k = top.shape[-1]
            for c, t in diff:
                p = np.sort(probs[c, t])[::-1]
                widest = max(widest, float((p[k - 1] - p[k]) / p[k - 1]))
                if (p[k - 1] - p[k]) / p[k - 1] >= SHT_MOE_TIE:
                    raise AssertionError(f"{label} step {s + 1} layer {layer}: token "
                                         f"{(int(c), int(t))} routed otherwise without a "
                                         f"tie: {p[:k + 1]}")
            n_tok = top.shape[0] * top.shape[1]
            flips.append(int(len(diff)))
    print(f"  {label}: routing equal to the unsharded router's on the same inputs as "
          f"integers but for {flips} tokens a step and layer (of {n_tok}, limit "
          f"{SHT_MOE_MAX_FLIPS:.0%}), each at a near tie: the widest relative gap of its K-th "
          f"and (K+1)-th probabilities {widest:.3g} (limit {SHT_MOE_TIE})", flush=True)
    if max(flips) > SHT_MOE_MAX_FLIPS * n_tok:
        raise AssertionError(f"{label}: {max(flips)} of {n_tok} tokens routed otherwise")
    return dict(flips=flips, tie=SHT_MOE_TIE, widest_gap=widest, tokens=n_tok)


def _sht_gnn_batches(kg: dict, work: Path, steps: int) -> dict:
    """Phase 10 (a)'s minibatches (its sampler over phase 8's KG, its
    geometry), each padded to a multiple of 512 edges as the reference's
    cells pad them: the padding edges are self-loops of an added node that
    no other node reaches and the loss leaves out."""
    batch_fn, _, info = kg_minibatches(kg)
    d = work / "gnn_batches"
    d.mkdir(parents=True)
    sizes = []
    for step in range(steps):
        b = {k: v.cpu().numpy() for k, v in batch_fn(step).items()}
        n, e = b["x"].shape[0], b["edge_index"].shape[1]
        pad = -e % SHT_EDGE_MULTIPLE
        if pad:
            b["x"] = np.concatenate([b["x"], np.zeros((1, b["x"].shape[1]), np.float32)])
            b["labels"] = np.concatenate([b["labels"], np.zeros(1, b["labels"].dtype)])
            b["train_mask"] = np.concatenate([b["train_mask"], np.zeros(1, np.float32)])
            b["edge_index"] = np.concatenate(
                [b["edge_index"], np.full((2, pad), n, np.int32)], axis=1)
            b["edge_attr"] = np.concatenate([b["edge_attr"], np.zeros((pad, 1), np.float32)])
        np.savez(d / f"step{step}.npz", **b)
        sizes.append((int(b["x"].shape[0]), int(b["edge_index"].shape[1]), pad))
    return dict(batches=str(d), sizes=sizes, graph=info)


def _sht_yardstick(job: dict) -> dict:
    """The job's unsharded run on the card, freed after."""
    t0 = time.perf_counter()
    out = sht_steps(job, None, "cuda")
    out["wall_s"] = time.perf_counter() - t0
    _free_card()
    return out


def sharded_training_phase(records: dict, kg: dict) -> dict:
    """Phase 11: sharded training (``launch.workloads`` cells on
    ``torch.distributed``), each cell against its unsharded yardstick run
    on the card first and freed before the ranks spawn; (a)-(d) in one
    spawn of 4 ranks through gloo, each on its mesh, (e) in another at
    world 1 on NCCL.  Returns the kernels' launches on the sharded GatedGCN
    run, summed over its ranks."""
    work = ROOT / "build" / "sharded_train"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()

    def at() -> str:
        return f"[{time.perf_counter() - t_phase:.0f} s]"

    gb = _sht_gnn_batches(kg, work, SHT_GNN_STEPS)
    prep = cells_prepare(kg, work)  # phase 12's inputs, yardsticks and dry-run counts
    print(f"  {at()} phase 12 prepared in {prep['prepare_s']:.1f} s", flush=True)
    cells = dict(dir=prep["dir"])
    nodes, edges, _ = gb["sizes"][0]
    meshes = [((2, 2), ("data", "model")), ((1, 2), ("data", "model")), ((2,), ("data",))]
    jobs = [
        # (a) Qwen2-1.5B at full width, depth cut; its step-2 state restored at
        # (data 1, model 2)
        dict(label="a", mesh=0, family="lm", arch="qwen2-1.5b", n_layers=SHT_LM_LAYERS,
             batch=SHT_LM_BATCH, seq=SHT_LM_SEQ, steps=SHT_LM_STEPS,
             save_after=SHT_LM_SAVE_AFTER, ckpt=str(work / "qwen2_ckpt")),
        # (b) DeepSeek-MoE-16B at full width, 2 layers: 32 experts a rank, 2 chunks
        dict(label="b", mesh=0, family="lm", arch="deepseek-moe-16b",
             n_layers=SHT_MOE_LAYERS, batch=SHT_MOE_BATCH, seq=SHT_MOE_SEQ,
             steps=SHT_MOE_STEPS, chunks=2, routes=True),
        # (c) GatedGCN at phase 10 (a)'s geometry, (data 2)
        dict(label="c", mesh=2, family="gnn", steps=SHT_GNN_STEPS, batches=gb["batches"],
             nodes=nodes, edges=edges),
        # (d) the Criteo-scale FM
        dict(label="d", mesh=0, family="fm", steps=SHT_FM_STEPS, batch=65_536),
    ]
    restore = dict(jobs[0], label="a_restore", mesh=1, restore=jobs[0]["ckpt"],
                   save_after=None)
    yard = {}
    for job in jobs:
        yard[job["label"]] = _sht_yardstick(job)
        print(f"  {at()} yardstick ({job['label']}) unsharded: "
              f"{[round(x['wall_s'], 3) for x in yard[job['label']]['steps']]} s a step",
              flush=True)
    ranks = _sht_spawn(work, "abcd", 4, "gloo", meshes=meshes,
                       jobs=jobs[:1] + [restore] + jobs[1:], cells=cells)
    print(f"  {at()} the sharded ranks done", flush=True)
    out: dict = {"card": card_line(), "yardsticks": yard}

    def runs(label):
        return [dict(r["jobs"][label], rank=r["rank"]) for r in ranks if label in r["jobs"]]

    a, ar = runs("a"), runs("a_restore")
    _sht_print_ranks(f"(a) Qwen2-1.5B, {SHT_LM_LAYERS} layers (data 2, model 2), "
                     "sequence-parallel", a)
    dry_a = _sht_dry_collectives(jobs[0], *meshes[0])
    for r in a:
        for x in r["steps"]:
            if x["collectives"] != dry_a["collectives"]:
                raise AssertionError(f"(a) rank {r['rank']} step {x['step'] + 1}: collectives "
                                     f"{x['collectives']} != the dry run's {dry_a['collectives']}")
    print(f"  (a) collectives a step on every rank == the dry run's: "
          f"{json.dumps(dry_a['collectives'])}; the dry run's peak {dry_a['peak_bytes']} B",
          flush=True)
    gaps = _sht_gaps("(a) Qwen2-1.5B (data 2, model 2)", "bf16", a[0]["steps"],
                     yard["a"]["steps"])
    _sht_print_ranks("(a) restored at (data 1, model 2)", ar)
    rgaps = _sht_gaps("(a) restored at (data 1, model 2)", "bf16", ar[0]["steps"],
                      yard["a"]["steps"][SHT_LM_SAVE_AFTER:])
    out["a"] = dict(config="qwen2-1.5b", layers=SHT_LM_LAYERS, tokens=SHT_LM_BATCH * SHT_LM_SEQ,
                    remat=True, sequence_parallel=True, ranks=a, gaps=gaps, restored=ar,
                    restored_gaps=rgaps, dryrun=dry_a)

    b = runs("b")
    _sht_print_ranks("(b) DeepSeek-MoE-16B, 2 layers (data 2, model 2)", b)
    routes = _sht_routes(b)
    replayed = _sht_yardstick(dict(jobs[1], replay=[[layer["top"] for layer in step]
                                                    for step in routes]))
    free_gaps = [dict(step=x["step"], loss_rel_gap=abs(x["loss"] - y["loss"]) / abs(y["loss"]),
                      gn_rel_gap=abs(x["gn"] - y["gn"]) / abs(y["gn"]))
                 for x, y in zip(b[0]["steps"], yard["b"]["steps"])]
    print(f"  {at()} (b) against the free unsharded run (routing unforced): "
          f"{json.dumps(free_gaps)}", flush=True)
    gaps = _sht_gaps("(b) DeepSeek-MoE-16B against the unsharded run on its routing",
                     "bf16", b[0]["steps"], replayed["steps"])
    routing = _sht_routing("(b) DeepSeek-MoE-16B", routes, replayed)
    for r in [yard["b"], replayed] + b:
        for x in r["steps"]:
            x.pop("routes", None)
    out["b"] = dict(config="deepseek-moe-16b", layers=SHT_MOE_LAYERS,
                    tokens=SHT_MOE_BATCH * SHT_MOE_SEQ, experts_a_rank=32, chunks=2,
                    ranks=b, replayed_yardstick=replayed, free_gaps=free_gaps, gaps=gaps,
                    routing=routing)

    c = runs("c")
    _sht_print_ranks("(c) GatedGCN (data 2)", c)
    gaps = _sht_gaps("(c) GatedGCN (data 2)", "f32", c[0]["steps"], yard["c"]["steps"])
    launches: dict = {}
    want = dict(segment_sum=64, dedup_order=2, search_bounds=2)  # 16 layers
    for r in c:
        for x in r["steps"]:
            if x["launches"] != want:
                raise AssertionError(f"(c) rank {r['rank']} step {x['step'] + 1}: launches "
                                     f"{x['launches']}, want {want}")
            for k, v in x["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"  (c) each rank a step: {json.dumps(want)} (32 forward, 32 backward); "
          f"{json.dumps(launches)} on the run, both ranks", flush=True)
    out["c"] = dict(config="gatedgcn", sizes=gb["sizes"], graph=gb["graph"], ranks=c,
                    gaps=gaps, launches=launches)

    d = runs("d")
    _sht_print_ranks("(d) FM Criteo-scale (data 2, model 2)", d)
    out["d"] = dict(config="fm", ranks=d,
                    gaps=_sht_gaps("(d) FM", "f32", d[0]["steps"], yard["d"]["steps"]))

    # (e) world 1 on NCCL: (c) and (a) at 2 layers, bit for bit
    e_jobs = [dict(jobs[2], label="gnn"),
              dict(family="lm", arch="qwen2-1.5b", n_layers=SHT_E_LM_LAYERS,
                   batch=SHT_LM_BATCH, seq=SHT_LM_SEQ, steps=SHT_LM_STEPS, label="lm")]
    (rank,) = _sht_spawn(work, "e", 1, "nccl", world1=True, jobs=e_jobs,
                         meshes=[((1, 1), ("data", "model"))], cells=cells)
    for label in ("gnn", "lm"):
        u, sh = rank["jobs"][label]["unsharded"], rank["jobs"][label]["sharded"]
        same = ([x["loss"] for x in u["steps"]] == [x["loss"] for x in sh["steps"]]
                and [x["gn"] for x in u["steps"]] == [x["gn"] for x in sh["steps"]]
                and u["digest"] == sh["digest"])
        print(f"  {at()} (e) world 1 on NCCL, {label}: sharded == unsharded bit for bit: "
              f"{same} (losses {[x['loss'] for x in sh['steps']]}, parameter digest "
              f"{sh['digest']})", flush=True)
        if not same:
            raise AssertionError(f"(e) {label}: the world-1 sharded run differs")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12: the serving and engine cells of launch/workloads (in phase 11's "
          f"ranks), sharded == unsharded, measured == the dry run's counts {at()}", flush=True)
    cell_rec, cell_launches = cells_check(prep, ranks, rank.pop("cells"))
    out["e"] = rank
    cell_rec["ranks_wall_s"] = [r["cells_wall_s"] for r in ranks]
    records["cells"] = cell_rec
    for r in ranks:
        r.pop("cells")
    for k, v in cell_launches.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  phase 12: prepared in {prep['prepare_s']:.1f} s, the ranks' cells in "
          f"{max(cell_rec['ranks_wall_s']):.1f} s; launches over the ranks "
          f"{json.dumps(cell_launches)}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    records["sharded_training"] = out
    return launches


# phase 12: the serving and engine cells of launch/workloads, in phase 11's ranks
CELL_LM = "smollm-135m"
# (a) cut from prefill_32k and decode_32k (32 x 32,768): the batch and the
# length, for gloo's host copies and the phase's time
CELL_LM_BATCH, CELL_LM_PROMPT, CELL_LM_STEPS = 4, 4096, 8
# (a)'s logits, sharded against unsharded, relative to the largest |logit|:
# 30 bf16 layers whose tensor-parallel sums run in another order, each a
# rounding of the residual stream apart (2^-8 relative), walk about
# sqrt(30) * 2^-8 = 2.1e-2 apart; an H100 read 2.0e-2 to 2.5e-2 over the
# prefill and 8 steps in each of three runs, and the limit is twice the
# largest
CELL_LM_TOL = 5e-2
CELL_FM_RTOL = 1e-5  # (b) f32 scores, of the largest score
# (c): phase 5's KG cut to the first 20,000 groups and 500,000 plain rows
# (860,000 rows, each shard under its 2^18 rows), and a sameAs star of
# CELL_ENGINE_MERGED groups (7 rows a group) as the round's delta.  The
# round routes each row's reflexive rows to their subjects' owners, so
# every <p sameAs p> of one predicate lands in one owner's bucket: on an
# H100 the busiest bucket took 53.5 rows a group (2,569 at 48 groups,
# 6,849 at 128), so route_cap's 4,096 rows overflow from 77 groups on, and
# 72 groups load it to about 3,850.  CELL_ENGINE_HOT runs 128 groups, and
# the round must flag exactly the ranks whose rows to one owner exceed
# route_cap
CELL_ENGINE_GROUPS, CELL_ENGINE_PLAIN, CELL_ENGINE_MERGED = 20000, 500000, 72
CELL_ENGINE_HOT = 128
CELL_MESH = ((2, 2), ("data", "model"))


def _cell_lm_specs(steps: int = CELL_LM_STEPS):
    """SmolLM-135M whole: its prefill cell at the prompt's length and its
    decode cell at the prompt plus ``steps``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec

    spec = get_arch(CELL_LM)
    b, s = CELL_LM_BATCH, CELL_LM_PROMPT
    return (spec, ShapeSpec(f"prefill_{b}x{s}", "prefill", dict(global_batch=b, seq_len=s)),
            ShapeSpec(f"decode_{b}x{s + steps}", "decode",
                      dict(global_batch=b, seq_len=s + steps)))


def _cell_lm_params(cfg, device):
    from repro_torch.models import transformer as lm

    return lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device)


def _cell_fm_specs():
    from repro_torch.configs import get_arch

    spec = get_arch("fm")
    return [(pallas, dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, use_pallas=pallas))) for pallas in (False, True)]


def _cell_fm_params(cfg, device):
    from repro_torch.models import recsys

    return recsys.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device)


def _cell_engine_spec(whole: bool = False):
    """``round_67m`` on the config's caps, or, for the unsharded round over
    the ``whole`` arena of the 4 shards, its capacity and caps times 4."""
    from repro_torch.configs import get_arch

    spec = get_arch("sameas_rew")
    shape = spec.shape("round_67m")
    if not whole:
        return spec, shape
    cfg = spec.config
    cfg = dataclasses.replace(cfg, bind_cap=4 * cfg.bind_cap, out_cap=4 * cfg.out_cap,
                              rewrite_cap=4 * cfg.rewrite_cap, route_cap=None)
    return (dataclasses.replace(spec, config=cfg),
            dataclasses.replace(shape, dims=dict(shape.dims,
                                                 capacity=4 * shape.dims["capacity"])))


def _cell_engine_rows(kg: dict, merged: int = CELL_ENGINE_MERGED) -> tuple:
    """Phase 5's KG cut (its group rows come first, 18 a group, then the
    plain rows), the sameAs stars <e_g_0 sameAs e_g_i> of the first
    ``merged`` groups as the delta (epoch 1, the rest 0), at round 2."""
    from repro_torch.core.terms import SAME_AS

    facts, dic = kg["facts"], kg["dic"]
    n_group_rows = FULL["n_groups"] * 18
    rows = np.concatenate([facts[:CELL_ENGINE_GROUPS * 18],
                           facts[n_group_rows:n_group_rows + CELL_ENGINE_PLAIN]])
    star = [(dic.id_of(f":e{g}_0"), SAME_AS, dic.id_of(f":e{g}_{i}"))
            for g in range(merged) for i in range(1, 8)]
    rows = np.concatenate([rows, np.asarray(star, np.int32)])
    epochs = np.zeros(rows.shape[0], np.int32)
    epochs[-len(star):] = 1
    return rows, epochs


def _engine_args(cell, arena, device) -> list:
    """This rank's blocks of the engine cell's global ``arena`` (numpy) as
    ``device`` tensors."""
    from repro_torch.launch.sharding import _to_tensor, local_block

    return [_to_tensor(local_block(a, sh), device) for a, sh in zip(arena, cell.in_shardings)]


ENGINE_NAMES = ("spo", "epoch", "marked", "n_used", "rep", "sort_perm", "sorted_keys")


def _engine_named(out) -> dict:
    return {**dict(zip(ENGINE_NAMES, out[:-1])), **out[-1]}


def cells_prepare(kg: dict, work: Path) -> dict:
    """Phase 12's inputs and yardsticks, in this process before phase 11's
    ranks spawn (each freed after): (a) SmolLM's unsharded prefill and
    decode on the card, (b) the FM's unsharded serve and retrieval under
    both settings, (c) one unsharded engine round over the whole arena; and
    the dry run's counts of each cell at (data 2, model 2), rank 0."""
    from repro_torch.launch.workloads import engine_arena, engine_rule
    from repro_torch.core.engine import eval_plan, process_candidates
    from repro_torch.models import recsys, transformer as lm

    d = work / "cells"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    out: dict = {"dir": str(d)}
    # (a)
    spec, pshape, dshape = _cell_lm_specs()
    cfg = spec.config
    rng = np.random.default_rng(12)
    tok = rng.integers(0, cfg.vocab, (CELL_LM_BATCH, CELL_LM_PROMPT + CELL_LM_STEPS))
    prompt, new = tok[:, :CELL_LM_PROMPT].astype(np.int32), tok[:, CELL_LM_PROMPT:].astype(np.int32)
    np.savez(d / "lm_inputs.npz", prompt=prompt, new=new)
    with torch.no_grad():
        params = _cell_lm_params(cfg, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, torch.from_numpy(prompt).cuda())
        yard = {"pre": logits.float().cpu().numpy()}
        whole = {k: torch.zeros((*v.shape[:2], dshape.dims["seq_len"], *v.shape[3:]),
                                dtype=v.dtype, device="cuda") for k, v in cache.items()}
        for k in whole:
            whole[k][:, :, :CELL_LM_PROMPT] = cache[k]
        del cache
        for i in range(CELL_LM_STEPS):
            logits, whole = lm.decode_step(params, cfg, whole,
                                           torch.from_numpy(new[:, i]).cuda(), CELL_LM_PROMPT + i)
            yard[f"dec{i}"] = logits.float().cpu().numpy()
        torch.cuda.synchronize()
        out["lm_yard_s"] = time.perf_counter() - t1
    np.savez(d / "lm_yard.npz", **yard)
    del params, whole, yard
    _free_card()
    # (b)
    rng = np.random.default_rng(13)
    fspec = _cell_fm_specs()[0][1]
    fcfg = fspec.config
    b = fspec.shape("serve_bulk").dims["batch"]
    n_cand = fspec.shape("retrieval_cand").dims["n_candidates"]
    cand = np.zeros((n_cand + 511) // 512 * 512, np.int32)  # sentinel rows pad them
    cand[:n_cand] = rng.integers(0, fcfg.n_rows, n_cand)
    ids = rng.integers(0, fcfg.rows_per_field, (b, fcfg.n_fields)).astype(np.int32)
    user = rng.integers(0, fcfg.rows_per_field, (1, fcfg.n_fields)).astype(np.int32)
    np.savez(d / "fm_inputs.npz", ids=ids, user=user, cand=cand)
    yard = {}
    with torch.no_grad():
        params = _cell_fm_params(fcfg, "cuda")
        for pallas, s in _cell_fm_specs():
            tag = "pallas" if pallas else "config"
            yard[f"serve_{tag}"] = recsys.serve_step(
                params, s.config, {"ids": torch.from_numpy(ids).cuda()}).cpu().numpy()
            yard[f"retrieval_{tag}"] = recsys.retrieval_scores(
                params, s.config, torch.from_numpy(user).cuda(),
                torch.from_numpy(cand).cuda()).cpu().numpy()
    np.savez(d / "fm_yard.npz", **yard)
    del params
    _free_card()
    # (c)
    rows, epochs = _cell_engine_rows(kg)
    espec, eshape = _cell_engine_spec()
    dims = eshape.dims
    np.savez(d / "engine_arena4.npz", *engine_arena(rows, dims["n_resources"], dims["capacity"],
                                                    4, r=2, epochs=epochs))
    hot, hot_epochs = _cell_engine_rows(kg, CELL_ENGINE_HOT)
    np.savez(d / "engine_arena4_hot.npz", *engine_arena(hot, dims["n_resources"],
                                                        dims["capacity"], 4, r=2,
                                                        epochs=hot_epochs))
    del hot, hot_epochs
    quarter = rows[:, 0] % 4 == 0
    np.savez(d / "engine_arena1.npz", *engine_arena(rows[quarter], dims["n_resources"],
                                                    dims["capacity"], 1, r=2,
                                                    epochs=epochs[quarter]))
    uspec, ushape = _cell_engine_spec(whole=True)
    arena = [torch.from_numpy(np.asarray(a)).cuda() for a in engine_arena(
        rows, dims["n_resources"], ushape.dims["capacity"], 1, r=2, epochs=epochs)]
    _, plan, slots = engine_rule()
    ucfg = uspec.config
    used = int(arena[4][0])
    with torch.no_grad():
        heads, valid, _, _, ov_b, ov_o = eval_plan(
            arena[0], arena[1], arena[2], arena[7], arena[6], arena[10], arena[8], arena[9],
            plan=plan, head_var_slots=slots, bind_cap=ucfg.bind_cap, out_cap=ucfg.out_cap,
            tomb=arena[3])
        res = process_candidates(arena[0], arena[1], arena[2], arena[4], arena[5], arena[6],
                                 arena[7], heads, valid, arena[10],
                                 rewrite_cap=ucfg.rewrite_cap)
    named = _engine_named(res)
    flags = {k: int(named[k]) for k in ("n_new", "n_pairs", "n_marked", "n_reflexive")}
    overflow = {k: bool(named[k]) for k in ("ov_rewrite", "ov_store")}
    overflow.update(bind=bool(ov_b), out=bool(ov_o))
    new_rows = named["spo"][used:int(named["n_used"][0])].cpu().numpy()
    np.savez(d / "engine_yard.npz", new_rows=new_rows, rep=named["rep"].cpu().numpy())
    out["engine"] = dict(rows=int(rows.shape[0]), delta=int(epochs.sum()),
                         unsharded=dict(flags, overflow=overflow))
    print(f"  (cells) engine arena: {rows.shape[0]} rows, {int(epochs.sum())} of them the "
          f"delta; unsharded round over the whole arena: {json.dumps(flags)}, overflow "
          f"{json.dumps(overflow)}", flush=True)
    if any(overflow.values()) or not flags["n_new"]:
        raise AssertionError("(cells) the unsharded engine round overflowed or found nothing")
    del arena, heads, valid, res, named
    _free_card()
    out["dryrun"] = cells_dryrun()
    out["prepare_s"] = time.perf_counter() - t0
    return out


def _cell_labels() -> list:
    """(label, spec, shape) of every measured cell of phase 12."""
    spec, pshape, dshape = _cell_lm_specs()
    cells = [("a_prefill", spec, pshape), ("a_decode", spec, dshape)]
    for pallas, s in _cell_fm_specs():
        tag = "pallas" if pallas else "config"
        cells += [(f"b_serve_{tag}", s, s.shape("serve_bulk")),
                  (f"b_retrieval_{tag}", s, s.shape("retrieval_cand"))]
    espec, eshape = _cell_engine_spec()
    return cells + [("c_engine", espec, eshape)]


def cells_dryrun() -> dict:
    """The dry run's counts of each phase-12 cell at (data 2, model 2),
    rank 0 of a fake group of 4 (destroyed after)."""
    from repro_torch.launch.dryrun import count_cell, fake_group
    from repro_torch.launch.mesh import make_mesh

    out = {}
    with fake_group(4, 0):
        mesh = make_mesh(*CELL_MESH)
        for label, spec, shape in _cell_labels():
            rec = count_cell(spec, shape, mesh)
            rec.update(arch=spec.name, shape=shape.name, mesh="d2m2", status="ok")
            out[label] = rec
    return out


def _measured(mesh, fn, warm=None):
    """``fn()`` timed (host clock, ending in a synchronise) with this
    rank's peak memory (and what was allocated when it began), launches
    and collectives from zero; ``warm()`` first, unmeasured, where given
    (the process's first call of a path loads its kernels and handles)."""
    from repro_torch.kernels import ops

    if warm is not None:
        warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mesh.reset_counts()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = dict(wall_s=time.perf_counter() - t0, allocated_before=before,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches={k: v for k, v in ops.LAUNCHES.items() if v},
               collectives=mesh.counts())
    return out, rec


def _placed(make):
    """``make()``, which puts a cell's inputs on the card, and the bytes it
    left allocated there: the inputs' size on the card."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = make()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def _route_loads(run):
    """``run()``, with the engine's owner routing (``core.engine._route_rows``)
    counting the rows this rank puts in each owner's bucket: ``(run()'s
    result, [[rows to owner 0, owner 1, ...] for each routing call])``."""
    from repro_torch.core import engine

    loads = []
    inner = engine._route_rows

    def counted(stream, flags, valid, mesh, route_cap):
        owner = torch.remainder(stream[:, 0], mesh.world).to(torch.int64)
        loads.append(torch.bincount(owner[valid], minlength=mesh.world))
        return inner(stream, flags, valid, mesh, route_cap)

    engine._route_rows = counted
    try:
        out = run()
    finally:
        engine._route_rows = inner
    return out, [x.tolist() for x in loads]


def cells_rank(cells: dict, mesh, device: str) -> dict:
    """Phase 12 on one rank of the (data 2, model 2) mesh: (a) SmolLM's
    prefill cell, its cache laid out again for the decode cell, and the
    decode steps; (b) the FM's serve and retrieval cells under both
    settings; (c) the engine round on the card, then on the CPU over the
    same gloo groups, and on the card at CELL_ENGINE_HOT's delta.  Each
    measured call records its inputs' bytes on the card.  Outputs go to
    ``cells["dir"]``."""
    from repro_torch.launch.sharding import gather, gather_tree, place
    from repro_torch.launch.workloads import build_cell

    d = Path(cells["dir"])
    rank = mesh.rank
    rec: dict = {"allocated_at_start": torch.cuda.memory_allocated()}
    save = {}
    # (a)
    spec, pshape, dshape = _cell_lm_specs()
    with np.load(d / "lm_inputs.npz") as z:
        prompt, new = z["prompt"], z["new"]
    pc, dc = build_cell(spec, pshape, mesh), build_cell(spec, dshape, mesh)
    params, param_bytes = _placed(
        lambda: place(_cell_lm_params(spec.config, device), pc.in_shardings[0], device))
    tok, tok_bytes = _placed(lambda: place(prompt, pc.in_shardings[1], device))
    (logits, cache), rec["a_prefill"] = _measured(mesh, lambda: pc.step(params, tok))
    rec["a_prefill"]["inputs_bytes"] = param_bytes + tok_bytes
    save["pre"] = gather(logits, pc.out_shardings[0]).float().cpu().numpy()
    whole = gather_tree(cache, pc.out_shardings[1])
    del cache, tok, logits
    t = dshape.dims["seq_len"]
    padded = {}
    for name in list(whole):
        block = whole.pop(name)
        padded[name] = torch.zeros((*block.shape[:2], t, *block.shape[3:]),
                                   dtype=block.dtype, device=device)
        padded[name][:, :, :CELL_LM_PROMPT] = block
        del block
    dcache, cache_bytes = _placed(lambda: place(padded, dc.in_shardings[1], device))
    del padded
    steps = []
    for i in range(CELL_LM_STEPS):
        t_i, t_bytes = _placed(lambda: place(new[:, i], dc.in_shardings[2], device))
        (logits, dcache), r = _measured(
            mesh, lambda: dc.step(params, dcache, t_i, CELL_LM_PROMPT + i))
        r["inputs_bytes"] = param_bytes + cache_bytes + t_bytes
        steps.append(r)
        save[f"dec{i}"] = gather(logits, dc.out_shardings[0]).float().cpu().numpy()
    rec["a_decode"] = dict(steps=steps)
    del params, dcache, logits, t_i
    _free_card()
    # (b)
    with np.load(d / "fm_inputs.npz") as z:
        fm = {k: z[k] for k in z.files}
    params = None
    for pallas, s in _cell_fm_specs():
        tag = "pallas" if pallas else "config"
        if params is None:  # replicated: every rank the same
            params, param_bytes = _placed(lambda: _cell_fm_params(s.config, device))
        sc = build_cell(s, s.shape("serve_bulk"), mesh)
        ids, in_bytes = _placed(lambda: place({"ids": fm["ids"]}, sc.in_shardings[1], device))
        got, rec[f"b_serve_{tag}"] = _measured(mesh, lambda: sc.step(params, ids),
                                               warm=lambda: sc.step(params, ids))
        rec[f"b_serve_{tag}"]["inputs_bytes"] = param_bytes + in_bytes
        save[f"serve_{tag}"] = gather(got, sc.out_shardings).cpu().numpy()
        del got, ids
        rc = build_cell(s, s.shape("retrieval_cand"), mesh)
        (user, cand), in_bytes = _placed(lambda: (
            torch.from_numpy(fm["user"]).to(device),
            place(fm["cand"], rc.in_shardings[2], device)))
        got, rec[f"b_retrieval_{tag}"] = _measured(mesh, lambda: rc.step(params, user, cand),
                                                   warm=lambda: rc.step(params, user, cand))
        rec[f"b_retrieval_{tag}"]["inputs_bytes"] = param_bytes + in_bytes
        save[f"retrieval_{tag}"] = gather(got, rc.out_shardings).cpu().numpy()
        del got, user, cand
    del params
    _free_card()
    # (c): the card, then the CPU through the same groups (gloo carries both)
    espec, eshape = _cell_engine_spec()
    ec = build_cell(espec, eshape, mesh)
    with np.load(d / "engine_arena4.npz") as z:
        arena = [z[f"arr_{i}"] for i in range(len(z.files))]
    runs = {}
    for dev in (device, "cpu"):
        if dev == device:
            args, in_bytes = _placed(lambda: _engine_args(ec, arena, device))
            # warmed up on a copy (the round writes spo and epoch), which
            # counts the rows routed to each owner
            loads = []
            out, rec["c_engine"] = _measured(
                mesh, lambda: ec.step(*args),
                warm=lambda: loads.extend(_route_loads(
                    lambda: ec.step(*_engine_args(ec, arena, device)))[1]))
            rec["c_engine"].update(inputs_bytes=in_bytes, route_loads=loads)
        else:
            args = _engine_args(ec, arena, dev)
            out = ec.step(*args)
        runs[dev] = {k: v.cpu().numpy() for k, v in _engine_named(out).items()}
        del args, out
    used_before = int(arena[4][rank])
    same = {k: bool(np.array_equal(runs[device][k], runs["cpu"][k])) for k in runs["cpu"]}
    rec["c_engine"].update(card_equals_cpu=same,
                           flags={k: runs[device][k].tolist() for k in
                                  ("n_new", "n_pairs", "n_marked", "n_reflexive",
                                   "ov_rewrite", "ov_store", "ov_route", "ov_pair")})
    got = runs[device]
    np.save(d / f"engine_new_r{rank}.npy", got["spo"][used_before:int(got["n_used"][0])])
    np.save(d / f"engine_rep_r{rank}.npy", got["rep"])
    # CELL_ENGINE_HOT's delta: the route bucket of the hot owner overflows
    with np.load(d / "engine_arena4_hot.npz") as z:
        arena = [z[f"arr_{i}"] for i in range(len(z.files))]
    out, loads = _route_loads(lambda: ec.step(*_engine_args(ec, arena, device)))
    hot = _engine_named(out)
    rec["c_engine_hot"] = dict(route_loads=loads, **{
        k: hot[k].cpu().reshape(-1).tolist() for k in
        ("n_new", "n_marked", "ov_rewrite", "ov_store", "ov_route", "ov_pair")})
    del out, hot, arena
    if rank == 0:
        np.savez(d / "cells_out.npz", **save)
    _free_card()
    return rec


def cells_world1(cells: dict, mesh, device: str) -> dict:
    """Phase 12 (d), world 1 on NCCL: (a)'s prefill and decode and (c)'s
    round (on shard 0's rows) through the cells of the (1, 1) mesh against
    the unsharded functions on this card, bit for bit."""
    from repro_torch.core.engine import eval_plan, process_candidates
    from repro_torch.launch.sharding import place
    from repro_torch.launch.workloads import build_cell, engine_rule
    from repro_torch.models import transformer as lm

    d = Path(cells["dir"])
    spec, pshape, dshape = _cell_lm_specs()
    cfg = spec.config
    with np.load(d / "lm_inputs.npz") as z:
        prompt, new = z["prompt"], z["new"]
    runs = []
    with torch.no_grad():
        for sharded in (True, False):
            params = _cell_lm_params(cfg, device)
            tok = torch.from_numpy(prompt).to(device)
            if sharded:
                pc, dc = build_cell(spec, pshape, mesh), build_cell(spec, dshape, mesh)
                params = place(params, pc.in_shardings[0], device)
                logits, cache = pc.step(params, tok)
            else:
                logits, cache = lm.prefill(params, cfg, tok)
            outs = [logits]
            full = {k: torch.zeros((*v.shape[:2], dshape.dims["seq_len"], *v.shape[3:]),
                                   dtype=v.dtype, device=device) for k, v in cache.items()}
            for k in full:
                full[k][:, :, :CELL_LM_PROMPT] = cache[k]
            for i in range(CELL_LM_STEPS):
                t_i = torch.from_numpy(new[:, i]).to(device)
                if sharded:
                    logits, full = dc.step(params, full, t_i, CELL_LM_PROMPT + i)
                else:
                    logits, full = lm.decode_step(params, cfg, full, t_i, CELL_LM_PROMPT + i)
                outs.append(logits)
            runs.append((outs, full))
            del params, cache
    lm_same = (all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
               and all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in ("k", "v")))
    del runs
    _free_card()
    espec, eshape = _cell_engine_spec()
    with np.load(d / "engine_arena1.npz") as z:
        arena = [z[f"arr_{i}"] for i in range(len(z.files))]
    ec = build_cell(espec, eshape, mesh)
    cell = {k: v.cpu() for k, v in _engine_named(ec.step(*_engine_args(ec, arena, device))).items()}
    a = [torch.from_numpy(np.asarray(x)).to(device) for x in arena]
    _, plan, slots = engine_rule()
    ecfg = espec.config
    with torch.no_grad():
        heads, valid, *_ = eval_plan(a[0], a[1], a[2], a[7], a[6], a[10], a[8], a[9],
                                     plan=plan, head_var_slots=slots, bind_cap=ecfg.bind_cap,
                                     out_cap=ecfg.out_cap, tomb=a[3])
        un = _engine_named(process_candidates(a[0], a[1], a[2], a[4], a[5], a[6], a[7],
                                              heads, valid, a[10],
                                              rewrite_cap=ecfg.rewrite_cap,
                                              route_cap=ecfg.route_cap))
    engine_same = all(torch.equal(cell[k].reshape(-1), un[k].cpu().reshape(-1)) for k in un)
    _free_card()
    return dict(lm_bit_equal=bool(lm_same), engine_bit_equal=bool(engine_same),
                engine_new=int(cell["n_new"][0]))


def _rel_gap(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def cells_check(prep: dict, ranks: list, world1: dict) -> tuple:
    """Phase 12's checks, after the spawns: (a)'s logits against the
    unsharded run within CELL_LM_TOL, (b)'s scores within CELL_FM_RTOL,
    (c) card == CPU on every rank, the union of the ranks' new rows equal
    to the unsharded round's and rho equal, (d) bit for bit; the dry run's
    collective bytes equal each rank's measured ones exactly; each rank's
    wall, peak and counts beside the dry run's peak and roofline time.
    Returns the record and the launches summed over the ranks."""
    from repro_torch.launch import roofline

    d = Path(prep["dir"])
    with np.load(d / "cells_out.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(d / "lm_yard.npz") as z:
        lm_yard = {k: z[k] for k in z.files}
    with np.load(d / "fm_yard.npz") as z:
        fm_yard = {k: z[k] for k in z.files}
    out: dict = {"card": card_line(), "prepare_s": prep["prepare_s"],
                 "engine_arena": prep["engine"]}
    gaps = {k: _rel_gap(got[k], lm_yard[k]) for k in lm_yard}
    print(f"  (a) SmolLM-135M whole, (data 2, model 2), prefill {CELL_LM_BATCH} x "
          f"{CELL_LM_PROMPT} then {CELL_LM_STEPS} decode steps: logits against the unsharded "
          f"run on the card, relative to the largest: {json.dumps(gaps)} (tolerance "
          f"{CELL_LM_TOL})", flush=True)
    if not max(gaps.values()) <= CELL_LM_TOL:
        raise AssertionError(f"(a) sharded logits differ beyond {CELL_LM_TOL}: {gaps}")
    out["a_gaps"] = gaps
    fm_gaps = {}
    for k, want in fm_yard.items():
        err = np.abs(got[k] - want)
        fm_gaps[k] = float(err.max()) / max(float(np.abs(want).max()), 1e-30)
        if got[k].shape != want.shape or not (err <= CELL_FM_RTOL * np.abs(want).max()).all():
            raise AssertionError(f"(b) {k}: sharded scores differ from unsharded: {fm_gaps[k]}")
    print(f"  (b) FM serve_bulk and retrieval_cand at (data 2, model 2), table replicated: "
          f"scores against unsharded, of the largest: {json.dumps(fm_gaps)} (tolerance "
          f"{CELL_FM_RTOL})", flush=True)
    out["b_gaps"] = fm_gaps
    # (c)
    with np.load(d / "engine_yard.npz") as z:
        want_rows, want_rep = z["new_rows"], z["rep"]
    union = np.concatenate([np.load(d / f"engine_new_r{r['rank']}.npy") for r in ranks])
    same_rows = np.array_equal(np.unique(union, axis=0), np.unique(want_rows, axis=0)) \
        and union.shape[0] == want_rows.shape[0]
    same_rep = all(np.array_equal(np.load(d / f"engine_rep_r{r['rank']}.npy"), want_rep)
                   for r in ranks)
    card_cpu = all(all(r["cells"]["c_engine"]["card_equals_cpu"].values()) for r in ranks)
    overflow = any(any(r["cells"]["c_engine"]["flags"][k][0] for k in
                       ("ov_rewrite", "ov_store", "ov_route", "ov_pair")) for r in ranks)
    cap = _cell_engine_spec()[0].config.route_cap
    by_rank = sorted(ranks, key=lambda r: r["rank"])
    loads = [max(max(x) for x in r["cells"]["c_engine"]["route_loads"]) for r in by_rank]
    print(f"  (c) engine round_67m over 4 shards, a delta of {prep['engine']['delta']} rows "
          f"({CELL_ENGINE_MERGED} groups): card == CPU on every rank: {card_cpu}; the "
          f"ranks' {union.shape[0]} new rows == the unsharded round's {want_rows.shape[0]}: "
          f"{same_rows}; rho equal: {same_rep}; flags by rank "
          f"{[r['cells']['c_engine']['flags'] for r in by_rank]}; the most rows a rank "
          f"routes to one owner, by rank: {loads} of route_cap {cap} (to each owner: "
          f"{[r['cells']['c_engine']['route_loads'] for r in by_rank]})", flush=True)
    if not (card_cpu and same_rows and same_rep) or overflow:
        raise AssertionError("(c) the sharded engine round differs or overflowed")
    hot = [r["cells"]["c_engine_hot"] for r in by_rank]
    hot_loads = [max(max(x) for x in h["route_loads"]) for h in hot]
    flagged = [bool(h["ov_route"][0]) for h in hot]
    print(f"  (c) the same round at a delta of {CELL_ENGINE_HOT} groups: the most rows a "
          f"rank routes to one owner, by rank: {hot_loads} of route_cap {cap} (to each "
          f"owner: {[h['route_loads'] for h in hot]}); ov_route by rank {flagged}; "
          f"{json.dumps([{k: v for k, v in h.items() if k != 'route_loads'} for h in hot])}",
          flush=True)
    if flagged != [x > cap for x in hot_loads] or not any(flagged):
        raise AssertionError(f"(c) at {CELL_ENGINE_HOT} groups ov_route {flagged} does not "
                             f"match the routed rows {hot_loads} over route_cap {cap}")
    out["c"] = dict(card_equals_cpu=card_cpu, new_rows=int(union.shape[0]),
                    union_equals_unsharded=bool(same_rows), rho_equal=bool(same_rep),
                    route_cap=cap, route_load_by_rank=loads,
                    hot=dict(groups=CELL_ENGINE_HOT, route_load_by_rank=hot_loads,
                             ov_route_by_rank=flagged))
    # (d)
    print(f"  (d) world 1 on NCCL: {json.dumps(world1)}", flush=True)
    if not (world1["lm_bit_equal"] and world1["engine_bit_equal"]):
        raise AssertionError(f"(d) world 1 differs from unsharded: {world1}")
    out["d"] = world1
    # each rank's measurements beside the dry run's counts
    launches: dict = {}
    out["cells"] = {}
    out["allocated_at_start"] = [r["cells"]["allocated_at_start"] for r in by_rank]
    print(f"  allocated on the card when phase 12 began, by rank (phase 11's leftovers): "
          f"{out['allocated_at_start']} B", flush=True)
    for label, dry in prep["dryrun"].items():
        want = {k: v["bytes"] for k, v in dry["collectives"]["by_kind"].items()}
        want_calls = {k: v["count"] for k, v in dry["collectives"]["by_kind"].items()}
        row = roofline.analyse(dry)
        bound_s = max(row["compute_s"], row["memory_s"], row["collective_s"])
        per_rank = []
        for r in by_rank:
            m = r["cells"][label]
            steps = m["steps"] if "steps" in m else [m]
            for s in steps:
                if s["collectives"]["bytes"] != want or s["collectives"]["calls"] != want_calls:
                    raise AssertionError(f"(cells) {label} rank {r['rank']}: measured "
                                         f"collectives {s['collectives']} != the dry run's "
                                         f"{want_calls} calls, {want} bytes")
                for k, v in s["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            # the cell's own peak: what it added to the rank's allocation,
            # and its inputs, measured on the card as they were placed
            per_rank.append(dict(
                rank=r["rank"], walls_s=[s["wall_s"] for s in steps],
                peak=max(s["max_memory_allocated"] for s in steps),
                allocated_before=max(s["allocated_before"] for s in steps),
                inputs_bytes=max(s["inputs_bytes"] for s in steps),
                own_peak=max(s["max_memory_allocated"] - s["allocated_before"]
                             + s["inputs_bytes"] for s in steps),
                launches=steps[-1]["launches"]))
        dry_peak, dry_in = dry["memory"]["peak_bytes"], dry["memory"]["argument_bytes"]
        peak = max(x["peak"] for x in per_rank)
        own = max(x["own_peak"] for x in per_rank)
        inputs = max(x["inputs_bytes"] for x in per_rank)
        held = max(x["allocated_before"] - x["inputs_bytes"] for x in per_rank)
        print(f"  {label}: walls by rank {[[round(w, 4) for w in x['walls_s']] for x in per_rank]}"
              f" s against the roofline's {bound_s * 1e3:.4f} ms ({row['dominant']}); the dry "
              f"run's peak {dry_peak} B over max_memory_allocated {peak} B: "
              f"{dry_peak / max(peak, 1):.3f}; of that, the cell's inputs measured on the card "
              f"{inputs} B (the dry run's {dry_in} B) and {held} B held from before it "
              f"began; over the cell's own peak (its rise plus its inputs) {own} B: "
              f"{dry_peak / max(own, 1):.3f}; collectives a call {json.dumps(want_calls)} "
              f"calls, {json.dumps(want)} B on every rank == the dry run's; launches a call "
              f"{json.dumps(per_rank[0]['launches'])}", flush=True)
        out["cells"][label] = dict(ranks=per_rank, own_peak=own, dryrun=dict(
            collectives=dry["collectives"], memory=dry["memory"], cost=dry["cost"],
            roofline=row))
    return out, launches


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


RUN_LIMIT_S = 1200 - 100  # the script's limit on the card, less a margin
# on a host like the final runs' of PR 27 (their readings beside each)
PHASES_BEFORE_PROFILER_S = 493  # the phases before the profiler jobs: 493-525 s
SHARDED_PHASE_S = 250  # the sharded training phase after them: 221-249 s
PROFILER_JOB_S = 10  # the longest of the kernels', REW's, ..., training's jobs: 5.8 s
SERVING_RERUN_S = 150  # the LM's and the MoE's profiled reruns: 82 and 141 s


def profiler_jobs(jobs: list, phases_s: float, longest_s: float) -> dict:
    """Run the queued profiler jobs in order while the sharded phase after
    them, and one more job of at most ``longest_s``, still fit
    ``RUN_LIMIT_S``: each scaled by how much slower than the reference run
    this host ran the phases so far (``phases_s``).  The jobs measure and
    check no result of the port, so a slow host skips the last of them.
    Prints and returns each job's seconds and the names of those skipped."""
    slow = max(1.0, phases_s / PHASES_BEFORE_PROFILER_S)
    reserve = slow * (SHARDED_PHASE_S + longest_s)
    ran, skipped = {}, []
    for job in jobs:
        name = getattr(job, "__qualname__", None) or job.func.__qualname__
        if RUN_LIMIT_S - (time.perf_counter() - T_PROCESS) < reserve:
            skipped.append(name)
            continue
        t0 = time.perf_counter()
        job()
        ran[f"{len(ran) + len(skipped)}:{name}"] = time.perf_counter() - t0
    out = dict(host_slower_by=slow, reserve_s=reserve, job_s=ran, skipped=skipped)
    print(f"  profiler jobs: {json.dumps(out)}", flush=True)
    return out


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
    # phase 10 (e)'s dry-run count, on the host while the kernels build
    lm_count = lm_peak_count_start()
    atexit.register(lm_count.kill)  # gone with the script, however it ends
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

    phase("the audit (probe traces on the card, full-size dispatch cross-checks):")
    audit_phase(records)

    # the LM's and the MoE's profiled reruns run after every other profiler
    # job: the FM's short session, begun after either trace (~10^5
    # kernels), has lost the FM kernels' events
    last: list = []
    phase("LM serving at full width (SmolLM-135M, flash):")
    launches["flash_attention"] = lm_serving_phase(ops, records, last)

    phase("MoE serving at full width (DeepSeek-MoE-16B whole, Qwen3-MoE-235B cut):")
    launches["flash_attention"] += moe_serving_phase(ops, records, last)

    phase("FM serving at full scale (Criteo-scale FM, rho):")
    fm_launches = fm_serving_phase(ops, records, later)
    for name in ("fm_interact", "embedding_bag"):
        launches[name] = fm_launches[name]

    phase("GNN inference on the sameAs-deduplicated KG (GatedGCN, PNA):")
    launches["segment_sum"] = gnn_phase(ops, records, kg)

    phase("the sharded engine (torch.distributed), card == CPU == unsharded:")
    sharded_phase(records, kg)

    phase("training on the card (GatedGCN on KG minibatches; EGNN, DimeNet, PNA, "
          "SmolLM-135M, the FM):")
    launches["segment_sum"] += training_phase(ops, ref, records, kg, later, lm_count)

    phase("the examples on the card (repro_torch.examples, at their defaults):")
    examples_phase(records)

    phase("device times under torch.profiler (kernels, REW, updates, FM serving, "
          "the training step, LM and MoE serving):")
    phases_s = time.perf_counter() - t_start
    records["profiler_jobs"] = [profiler_jobs(later, phases_s, PROFILER_JOB_S),
                                profiler_jobs(last, phases_s, SERVING_RERUN_S)]

    # after the profiler sessions: its ranks are fresh processes (CUPTI
    # dropped every event of the FM's profiled rerun when this phase ran
    # before them)
    phase("sharded training (launch.workloads cells on torch.distributed), sharded == "
          "unsharded:")
    for name, n in sharded_training_phase(records, kg).items():
        launches[name] += n

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
