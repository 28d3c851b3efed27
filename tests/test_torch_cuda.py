"""The hand-written kernels, the engine, the two serving paths and the GNNs
on the card: each kernel equals its plain version on the same CUDA tensors
(exactly for the integer kernels; for flash attention within 2e-2 and
within rtol 2^-7 plus 1e-4 in bf16, with P.V kept at more than bf16
precision, and within 1e-5 in f32; for the FM interaction within rtol
1e-5; for the segment sum and the embedding bag within 1e-5 of the sum of
the absolute values summed, f32 sums in another order), and a run on the
card equals the run on the CPU (the MoE layer and model with routing flips
only at near ties, each test stating its tolerance).  Needs an NVIDIA card with nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from kernel_patterns import (
    BAG_PATTERNS, BAG_SHAPES, FM_SHAPES, REWRITE_CASES, SEARCH_PATTERNS,
    SEGMENT_PATTERNS, UNION_PATTERNS, bag_case, fm_case, prefix_case, rewrite_case,
    search_case, segment_case, union_case,
)
from repro_torch.core.engine import TorchEngine
from repro_torch.core.triples import pack
from repro_torch.data.generator import PROFILES, generate, sample_update_stream
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.data.graphs import build_graph_from_kg, dedup_graph, graph_to, random_graph
from repro_torch.models import moe, recsys, transformer as lm
from repro_torch.models.gnn import gatedgcn, pna
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparql import Query, evaluate_at

pytestmark = pytest.mark.cuda
KEY_MAX = (1 << 63) - 1
RADIX_TILE = 4096  # keys a block of the dedup_order kernel sorts


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x.cpu(), y.cpu())


def _check_dedup(keys):
    """The kernel's order is torch's stable argsort, bit for bit, and the
    call counts one launch."""
    before = ops.LAUNCHES["dedup_order"]
    got = ops.dedup_order(keys)
    assert ops.LAUNCHES["dedup_order"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.argsort(keys, stable=True).to(torch.int32))
    return got


@pytest.mark.parametrize("n", [1, 2, 2047, 2049, RADIX_TILE - 1,
                               RADIX_TILE + 1, 100_003, (1 << 20) + 3,
                               (1 << 24) + 1])
def test_dedup_order(dev, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 1 << 40, n)).to(dev)
    keys[rng.integers(0, n, n // 3)] = 7
    keys[-max(n // 8, 1):] = KEY_MAX
    _same([_check_dedup(keys)], [ref.dedup_order(keys)])


def test_dedup_order_tile_is_the_sources(dev):
    """The kernel's scratch grows by one tile's status words at every
    RADIX_TILE keys, so the edge cases above sit at its tile edges."""
    words = ops.dedup_order_scratch_words
    assert words(1) == words(RADIX_TILE) < words(RADIX_TILE + 1)


def _dedup_keys(pattern: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(len(pattern))
    if pattern == "all_equal":
        return np.full(n, -12345, dtype=np.int64)
    if pattern == "negative":  # the whole int64 range, LLONG_MIN included
        keys = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        keys[rng.integers(0, n, 64)] = -(1 << 63)
        keys[rng.integers(0, n, 64)] = -1
        return keys
    if pattern == "minus_one_zero_max":
        return rng.choice(np.array([-1, 0, KEY_MAX], dtype=np.int64), n)
    if pattern == "one_middle_digit":  # all digits but bits 24-31 trivial
        return (np.int64(0x0123_4567_0089_ABCD)
                | (rng.integers(0, 256, n).astype(np.int64) << 24))
    if pattern == "segment_ids":  # the GNN plan in small: a 17 % hub and
        seg = rng.integers(0, 50_000, n).astype(np.int32)  # ids out of range
        seg[rng.random(n) < 0.17] = 4242
        seg[rng.random(n) < 0.01] = -1
        seg[rng.random(n) < 0.005] = -7
        return seg.astype(np.int64)
    raise ValueError(pattern)


@pytest.mark.parametrize("pattern", ["all_equal", "negative", "minus_one_zero_max",
                                     "one_middle_digit", "segment_ids"])
def test_dedup_order_key_patterns(dev, pattern):
    keys = torch.from_numpy(_dedup_keys(pattern, 300_007)).to(dev)
    first = _check_dedup(keys)
    assert torch.equal(first, _check_dedup(keys))  # two calls, the same bits


def test_search_and_prefix(dev):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (5000, 3))
    keys = torch.from_numpy(np.sort((ids[:, 0] << 42) | (ids[:, 1] << 21) | ids[:, 2])).to(dev)
    queries = keys[torch.from_numpy(rng.integers(0, 5000, 3000)).to(dev)].contiguous()
    _same(ops.search_bounds(queries, keys), ref.search_bounds(queries, keys))
    for k in (1, 2, 3):
        prefix = torch.from_numpy(rng.integers(0, 52, (3000, k)).astype(np.int32)).to(dev)
        _same(ops.prefix_range_bounds(prefix, keys), ref.prefix_range_bounds(prefix, keys))


SEARCH_TILE = 1024   # queries a block of the search kernel answers
SEARCH_WINDOW = 4096  # keys it holds in shared memory


def _check_search(queries, keys):
    """Both sides and each side alone equal the plain version bit for bit,
    one launch a call."""
    want = ref.search_bounds(queries, keys)
    before = ops.LAUNCHES["search_bounds"]
    _same(ops.search_bounds(queries, keys), want)
    _same([ops.searchsorted(keys, queries)], want[:1])
    _same([ops.searchsorted(keys, queries, side="right")], want[1:])
    assert ops.LAUNCHES["search_bounds"] == before + 3 * (queries.shape[0] > 0)


@pytest.mark.parametrize("pattern", SEARCH_PATTERNS)
def test_search_patterns(dev, pattern):
    """Windows larger than shared memory (a KEY_MAX tail of v/8, cumsum
    plateaus, every query one of a third of the keys), a tile sorted but
    for one pair, runs of equal queries across tiles, no order."""
    queries, keys = search_case(pattern, 300_007, 65_537, seed=5)
    assert keys.shape[0] // 8 > SEARCH_WINDOW
    _check_search(torch.from_numpy(queries).to(dev), torch.from_numpy(keys).to(dev))


@pytest.mark.parametrize("n,v", [(0, 10), (10, 0), (10, 1), (1, 1),
                                 (SEARCH_TILE + 1, 1), (SEARCH_TILE - 1, 3),
                                 (3 * SEARCH_TILE, SEARCH_WINDOW + 1)])
def test_search_sizes(dev, n, v):
    queries, keys = search_case("key_max_tail", n, v, seed=n + v)
    _check_search(torch.from_numpy(queries).to(dev), torch.from_numpy(keys).to(dev))


@pytest.mark.parametrize("sorted_rows", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_prefix_patterns(dev, sorted_rows, k):
    rows, keys = prefix_case(sorted_rows, 100_003, 40_000, k, seed=k)
    rows_t, keys_t = torch.from_numpy(rows).to(dev), torch.from_numpy(keys).to(dev)
    _same(ops.prefix_range_bounds(rows_t, keys_t), ref.prefix_range_bounds(rows_t, keys_t))


@pytest.mark.parametrize("pattern,n", [*REWRITE_CASES, ("rows", 100_003),
                                       ("unaligned", 100_003)])
def test_rewrite_triples(dev, pattern, n):
    """Every mask form equals the plain version: row counts around groups
    of 4 and tiles of 128, a view one row in (no operand 16-byte aligned),
    ids outside rho."""
    spo, rho, valid, epoch, marked, start = rewrite_case(pattern, n, seed=n)
    spo, valid, epoch, marked = (torch.from_numpy(x).to(dev)[start:]
                                 for x in (spo, valid, epoch, marked))
    rho = torch.from_numpy(rho).to(dev)
    assert (spo.data_ptr() % 16 == 0) == (start == 0)
    before = ops.LAUNCHES["rewrite_triples"]
    for kw in ({}, {"valid": valid}, {"epoch": epoch, "marked": marked},
               {"valid": valid, "epoch": epoch, "marked": marked}):
        _same(ops.rewrite_triples(spo, rho, **kw), ref.rewrite_triples(spo, rho, **kw))
    assert ops.LAUNCHES["rewrite_triples"] == before + 4


@pytest.mark.parametrize("pattern", UNION_PATTERNS)
def test_union_find(dev, pattern):
    """Union then compress on the card equals the plain version, and two
    card runs give the same bits, whatever order the hooks landed in; the
    union is one launch."""
    rep, pairs, valid = union_case(pattern, 50_000, seed=len(pattern))
    pairs_t, valid_t = torch.from_numpy(pairs).to(dev), torch.from_numpy(valid).to(dev)
    runs = []
    for _ in range(2):
        got = torch.from_numpy(rep).to(dev)
        before = ops.LAUNCHES["uf_union"]
        ops.uf_union_(got, pairs_t, valid_t)
        assert ops.LAUNCHES["uf_union"] == before + 1
        assert bool((got <= torch.arange(got.shape[0], device=dev)).all())
        ops.uf_compress_(got)
        runs.append(got)
    want = torch.from_numpy(rep).to(dev)
    ref.uf_union_(want, pairs_t, valid_t)
    ref.uf_compress_(want)
    _same(runs[:1], [want])
    _same(runs[1:], [want])
    if pattern == "permuted_chain":  # one clique; its minimum is resource 0
        assert int(runs[0].max()) == 0


def test_union_find_unaligned(dev):
    """Pairs and flags one row in: a pair a thread throughout."""
    rep, pairs, valid = union_case("hub", 50_000, seed=5)
    pairs_t = torch.from_numpy(pairs).to(dev)[1:]
    valid_t = torch.from_numpy(valid).to(dev)[1:]
    got = torch.from_numpy(rep).to(dev)
    ops.uf_union_(got, pairs_t, valid_t)
    ops.uf_compress_(got)
    want = torch.from_numpy(rep).to(dev)
    ref.uf_union_(want, pairs_t, valid_t)
    _same([got], [want])


@pytest.mark.parametrize("name", ["opencyc_like", "merge_like", "uobm_like"])
def test_engine_on_card_equals_cpu(dev, name):
    facts, program, dic = generate(**PROFILES[name])
    results = [TorchEngine(dic.n_resources, device=d).materialise(facts, program)
               for d in (dev, "cpu")]
    (spo, rep, stats), (cspo, crep, cstats) = results
    np.testing.assert_array_equal(np.sort(pack(spo)), np.sort(pack(cspo)))
    np.testing.assert_array_equal(rep, crep)
    assert stats.as_dict() | {"wall_seconds": 0} == cstats.as_dict() | {"wall_seconds": 0}


FUSED_COUNTERS = ("derivations", "rule_applications", "merged_resources",
                  "reflexive_added", "rounds", "triples_total", "triples_explicit",
                  "rule_rewrites", "rules_requeued", "sameas_pairs")


def _run_counted(eng, facts, program):
    ops.reset_launches()
    state = eng.materialise_state(facts, program)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    return (np.sort(pack(eng.state_triples(state))), eng.state_rep(state),
            state.stats, launches)


@pytest.mark.parametrize("name", ["opencyc_like", "merge_like"])
def test_fused_equals_host_loop_on_card(dev, name):
    """The fused loop (an eager first round, then one CUDA graph replay a
    round) and the host loop give the same triples, rho and counters; a
    replay counts the launches of one eager round of the same body; the
    kernels every round launches once (the union-find) or three times (the
    rewrite) count the same in both loops."""
    from repro_torch.core import fused

    facts, program, dic = generate(**PROFILES[name])
    caps = dict.fromkeys(("capacity", "bind_cap", "out_cap", "rewrite_cap"), 1 << 16)
    engines = {mode: TorchEngine(dic.n_resources, device=dev, fuse_rounds=fuse, **caps)
               for mode, fuse in (("graph", True), ("host", False))}
    runs = {mode: _run_counted(eng, facts, program) for mode, eng in engines.items()}
    spo, rep, stats, launches = runs["graph"]
    hspo, hrep, hstats, hlaunches = runs["host"]
    np.testing.assert_array_equal(spo, hspo)
    np.testing.assert_array_equal(rep, hrep)
    for k in FUSED_COUNTERS:
        assert getattr(stats, k) == getattr(hstats, k), k
    assert stats.capacity_retries == 0  # every launch counted is of these rounds
    graph = engines["graph"]._graph
    assert graph is not None and graph.graph is not None

    eng = engines["graph"]
    state = eng._fresh_state(program)
    cands, valid = eng._pad_cands(facts)
    before = dict(ops.LAUNCHES)
    fused.forward_round(fused.new_carry(state, cands, valid),
                        fused.round_tables(program, dev),
                        fused.forward_plan_signature(program),
                        rewrite_cap=eng.rewrite_cap, bind_cap=eng.bind_cap,
                        plan_out_cap=eng.out_cap)
    eager = {k: n - before[k] for k, n in ops.LAUNCHES.items() if n != before[k]}
    assert eager == graph.launches
    for k in ("rewrite_triples", "uf_union", "uf_compress"):
        assert launches[k] == hlaunches[k] == eager[k] * stats.rounds, k
    assert launches["uf_union"] == launches["uf_compress"] == stats.rounds
    if name == "merge_like":
        assert stats.rule_rewrites >= 1  # a consts_changed exit on the card


def test_fused_graph_is_reused_across_calls(dev):
    facts, program, dic = generate(**PROFILES["opencyc_like"])
    eng = TorchEngine(dic.n_resources, device=dev)
    first = eng.materialise(facts, program)
    graph = eng._graph
    assert graph is not None and graph.graph is not None
    captured = graph.graph
    second = eng.materialise(facts, program)
    assert eng._graph is graph and graph.graph is captured  # no new capture
    np.testing.assert_array_equal(np.sort(pack(first[0])), np.sort(pack(second[0])))
    np.testing.assert_array_equal(first[1], second[1])
    # the second run starts at the grown capacities: no restart to count
    same = {"wall_seconds": 0, "capacity_retries": 0}
    assert first[2].as_dict() | same == second[2].as_dict() | same
    assert all(r["reads"] == 1 for r in eng.last_split["rounds"])


def test_fused_round_body_makes_no_sync(dev):
    """The round body has no host read: under the sync debug mode "error"
    one eager round raises on any synchronising call."""
    from repro_torch.core import fused

    facts, program, dic = generate(**PROFILES["merge_like"])
    eng = TorchEngine(dic.n_resources, device=dev)
    state = eng._fresh_state(program)
    cands, valid = eng._pad_cands(facts)
    carry = fused.new_carry(state, cands, valid)
    tables = fused.round_tables(program, dev)
    plans = fused.forward_plan_signature(program)
    caps = dict(rewrite_cap=eng.rewrite_cap, bind_cap=eng.bind_cap,
                plan_out_cap=eng.out_cap)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            fused.forward_round(carry, tables, plans, **caps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fl = dict(zip(fused.FLAGS, carry["flags"].tolist()))
    assert fl["iters"] == 2


@pytest.mark.parametrize("n_shards", [1, 4])
def test_rewrite_owner(dev, n_shards):
    spo, rho, *_ = rewrite_case("rows", 100_003, seed=11)
    args = (torch.from_numpy(spo).to(dev), torch.from_numpy(rho).to(dev))
    before = ops.LAUNCHES["rewrite_triples"]
    got = ops.rewrite_owner(*args, n_shards)
    assert ops.LAUNCHES["rewrite_triples"] == before + 1
    _same(got, ref.rewrite_owner(*args, n_shards))


def _update_stream(name="opencyc_like", n_events=4, batch=8, seed=0):
    kw = dict(PROFILES[name], n_groups=8, n_plain=120)
    facts, program, dic = generate(**kw)
    events = sample_update_stream(facts, dic, n_events=n_events, batch=batch,
                                  seed=seed)
    return facts, program, dic.n_resources, events


def _state_arrays(state):
    from repro_torch.core.engine import state_to_arrays

    return {k: v.copy() for k, v in state_to_arrays(state).items()}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "host_loop"])
def test_incremental_stream_on_card_equals_cpu(dev, fuse):
    """add_facts/delete_facts on the card (the fused loops: a round graph
    and a wave graph replayed) equal the CPU's after every event: the
    arrays, the explicit set, the program and every counter."""
    facts, program, n_res, events = _update_stream(n_events=6, seed=1)
    assert {"add", "delete"} <= {op for op, _ in events}
    engines = [TorchEngine(n_res, device=d, fuse_rounds=fuse) for d in (dev, "cpu")]
    states = [e.materialise_state(facts, program) for e in engines]
    for op, delta in events:
        for e, st in zip(engines, states):
            (e.add_facts if op == "add" else e.delete_facts)(st, delta)
        card, host = (_state_arrays(st) for st in states)
        for k in card:
            np.testing.assert_array_equal(card[k], host[k], err_msg=f"{op} {k}")
        assert (np.sort(pack(TorchEngine.explicit_rows(states[0])))
                == np.sort(pack(TorchEngine.explicit_rows(states[1])))).all()
        assert states[0].program.rules == states[1].program.rules
        same = {"wall_seconds": 0}
        assert states[0].stats.as_dict() | same == states[1].stats.as_dict() | same
        labels = [[lb for lb, _ in e.last_split["phases"]] for e in engines]
        assert labels[0] == labels[1]
    assert states[0].stats.overdeleted and states[0].stats.od_waves


def test_wave_graph_is_reused_across_deletes(dev):
    """The fused waves of a delete run as replays of one captured graph
    with one host read a wave; a later delete with the same key replays
    the same graph, captured once."""
    from repro_torch.core import fused

    facts, program, n_res, events = _update_stream(n_events=6, seed=1)
    eng = TorchEngine(n_res, device=dev)
    state = eng.materialise_state(facts, program)
    graphs = set()
    for op, delta in events:
        waves = state.stats.od_waves
        (eng.add_facts if op == "add" else eng.delete_facts)(state, delta)
        for g in eng._graphs.values():
            if isinstance(g, fused.WaveGraph):
                graphs.add(g)
        if op == "delete" and state.stats.od_waves - waves > 1:
            assert any(g.graph is not None for g in graphs)
    wave_graphs = [g for g in eng._graphs.values() if isinstance(g, fused.WaveGraph)]
    assert len(wave_graphs) == len(graphs) == 1  # the same key each delete
    assert wave_graphs[0].graph is not None


def test_a_state_is_unchanged_by_another_states_updates(dev):
    """The graphs' buffers are the engine's: a state handed out before is
    left alone by the updates of another state through the same graphs."""
    facts, program, n_res, events = _update_stream(n_events=6, seed=1)
    eng = TorchEngine(n_res, device=dev)
    first = eng.materialise_state(facts, program)
    before = _state_arrays(first)
    second = eng.materialise_state(facts, program)
    for op, delta in events:
        (eng.add_facts if op == "add" else eng.delete_facts)(second, delta)
    for k, v in _state_arrays(first).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,q_offset", [
    (1, 200, 200, 9, 3, 64, True, 0),      # SmolLM prefill
    (4, 1, 300, 9, 3, 64, True, 211),      # decode row at an offset
    (2, 33, 77, 8, 2, 128, True, 5),       # D 128, ragged tiles
    (2, 70, 70, 4, 4, 64, False, 0),       # not causal
    (1, 22, 22, 3, 1, 64, True, 0),        # 66 flat rows: two warpgroups, one nearly idle
    (1, 1000, 1000, 9, 3, 64, True, 0),    # G 3: flat rows of a query split across blocks
    (2, 45, 130, 6, 2, 128, True, 85),     # D 128, q_offset > 0, T = q_offset + S
    (1, 129, 200, 12, 4, 64, False, 0),    # not causal, S and T not multiples of 64
    (3, 1, 77, 9, 3, 128, True, 60),       # decode step, D 128
    # grids of at least two blocks an SM: the long-prefill route
    (4, 2048, 2048, 9, 3, 64, True, 0),
    (4, 2048, 2048, 9, 3, 128, True, 0),
    (2, 2000, 1900, 12, 4, 64, False, 0),  # not causal, ragged S and T
    (3, 1500, 2100, 9, 3, 128, True, 600),  # q_offset > 0
    # the MoE models' heads: DeepSeek's MHA and Qwen3's G 16 prefills, and
    # a 16-row decode step at G 16
    (1, 512, 512, 16, 16, 128, True, 0),
    (1, 512, 512, 64, 4, 128, True, 0),
    (16, 1, 1024, 64, 4, 128, True, 700),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention(dev, b, s, t, h, kv, d, causal, q_offset, dtype):
    g = torch.Generator(device=dev).manual_seed(s + t)
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, t, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, t, kv, d, generator=g, device=dev).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:  # and one rounding of the output apart
        torch.testing.assert_close(got.float(), want.float(), atol=FLASH_ATOL,
                                   rtol=FLASH_RTOL)


FLASH_RTOL = 2.0**-7  # one bf16 rounding of the value
FLASH_ATOL = 1e-4     # well under the spread of an output row at 32k keys


def _attention_f32(q, k, v, causal, q_offset, p_kind):
    """Attention in f32 from whole score matrices, with P.V taken from P in
    f32 (``"f32"``), from bf16(P) (``"bf16"``) or from bf16(P) plus
    bf16(P - bf16(P)) (``"split"``)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float().reshape(b, s, kv, h // kv, d),
                          k.float()) / d**0.5
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)
        keep = q_pos[:, None] >= torch.arange(t, device=q.device)[None, :]
        scores = torch.where(keep, scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if p_kind != "f32":
        hi = p.to(torch.bfloat16).float()
        p = hi if p_kind == "bf16" else hi + (p - hi).to(torch.bfloat16).float()
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float()) / l.permute(0, 3, 1, 2, 4)
    return o.reshape(b, s, h, d)


@pytest.mark.parametrize("b,s,t,h,kv,d,long_route", [
    (1, 512, 512, 9, 3, 64, False),   # the LM server's prefill: split KV
    (4, 2048, 2048, 9, 3, 64, True),
    (4, 2048, 2048, 9, 3, 128, True),
])
def test_flash_attention_keeps_p_in_f32(dev, b, s, t, h, kv, d, long_route):
    """The bf16 route splits P into two bf16 halves for P.V.  Against
    bf16 of the f32 reference, a kernel that took P.V from bf16(P) would
    round many more outputs the other way; the kernel's share of outputs
    rounded otherwise must lie below the midpoint of the two schemes'."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (-(-s * (h // kv) // 128) * kv * b >= 2 * sms) == long_route
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn(b, n, heads, d, generator=g, device=dev).to(torch.bfloat16)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    want = _attention_f32(q, k, v, True, 0, "f32").to(torch.bfloat16)

    def share(out):
        return float((out != want).float().mean())

    got = share(ops.flash_attention(q, k, v))
    split = share(_attention_f32(q, k, v, True, 0, "split").to(torch.bfloat16))
    rounded = share(_attention_f32(q, k, v, True, 0, "bf16").to(torch.bfloat16))
    assert rounded > 4 * split, (split, rounded)  # the inputs tell them apart
    assert got < (split + rounded) / 2, (got, split, rounded)


def test_flash_attention_reads_a_cache_layer_in_place(dev):
    """A layer of the (L, B, T, KV, D) arena and a transposed K are read
    through their strides."""
    g = torch.Generator(device=dev).manual_seed(9)
    arena = torch.randn(2, 4, 64, 3, 64, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(4, 1, 9, 64, generator=g, device=dev).to(torch.bfloat16)
    torch.testing.assert_close(ops.flash_attention(q, arena[1], arena[0], q_offset=40),
                               ref.flash_attention(q, arena[1], arena[0], q_offset=40),
                               atol=2e-2, rtol=0)
    with pytest.raises(ValueError):  # head dims other than 64 and 128
        ops.flash_attention(q[..., :32], arena[1][..., :32], arena[0][..., :32])


@pytest.mark.parametrize("b,f,k", [(512, 39, 10), (1000, 26, 16), (100, 7, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_interact(dev, b, f, k, dtype):
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn(b, f, k, generator=g, device=dev).to(dtype)
    got, want = ops.fm_interact(x), ref.fm_interact(x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:  # one bf16 rounding of the output apart at most
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-3)


def _check_fm(x):
    """The kernel against its plain version: 1e-5 of max(1, the largest
    |out|) in f32 (chip_smoke's limit), one bf16 rounding in bf16; two calls
    give the same bits."""
    got = ops.fm_interact(x)
    assert torch.equal(got, ops.fm_interact(x))
    want = ref.fm_interact(x)
    assert got.dtype == x.dtype and got.shape == want.shape
    if x.dtype == torch.float32:
        limit = 1e-5 * max(1.0, float(want.abs().max()))
    else:
        limit = 2 ** -7 * want.float().abs() + 1e-3
    assert bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("b,f,k", [*FM_SHAPES, (100_001, 39, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_interact_tiles(dev, b, f, k, dtype):
    """The edges of the slab route (one row, batches no multiple of a
    slab, 1 to 100 fields, rows of odd byte length) and of the row route
    (K > 32, a row larger than a stage)."""
    _check_fm(torch.from_numpy(fm_case(b, f, k, seed=b + f + k)).to(dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_interact_unaligned(dev, dtype):
    """x one value past an aligned start: the row route."""
    x = fm_case(1000, 39, 10, seed=5)
    flat = torch.from_numpy(np.concatenate([[0.0], x.reshape(-1)]).astype(np.float32))
    _check_fm(flat.to(dev).to(dtype)[1:].view(1000, 39, 10))


def _to(tree, dev):
    """A parameter tree (dicts, lists, tuples of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def test_lm_serving_on_card_equals_cpu(dev):
    """SmolLM-135M's widths at 2 layers with the flash kernel: the card's
    prefill and teacher-forced decode logits equal the CPU's within 0.1
    (bf16 logits below 8), and the server runs every request."""
    cfg = dataclasses.replace(get_arch("smollm-135m").config, n_layers=2,
                              attn_impl="flash")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = _to(params, dev)
    prompt = torch.arange(2, 40).reshape(1, -1)
    tokens = [5, 77, 1234]
    logits = {}
    for name, p in (("cuda", card), ("cpu", params)):
        d = p["embed"].device
        out, cache = lm.prefill(p, cfg, prompt.to(d))
        arena = lm.init_cache(cfg, 1, 64, device=d)
        for key in arena:
            arena[key][:, :, :prompt.shape[1]] = cache[key]
        seq = [out[0, -1].float().cpu()]
        for i, tok in enumerate(tokens):
            out, arena = lm.decode_step(p, cfg, arena, torch.tensor([tok], device=d),
                                        prompt.shape[1] + i)
            seq.append(out[0].float().cpu())
        logits[name] = torch.stack(seq)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=0.1, rtol=0)
    before = ops.LAUNCHES["flash_attention"]
    eng = ServeEngine(card, cfg, n_slots=2, max_len=64, eos_id=-1)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=list(range(2, 10 + i)), max_new=4))
    assert len(eng.run()) == 3
    assert ops.LAUNCHES["flash_attention"] == before + 3 * cfg.n_layers


MOE_FLIP_MARGIN = 1e-3  # a routing flip between card and CPU at a wider gap fails


def _routed(run, replay=None):
    """``run()`` under a routing log that keeps every call's probabilities
    and its router's own top k (``replay``: the top k the calls take)."""
    with moe.routing_log(moe.RoutingLog(keep_calls=True, replay=replay)) as log:
        out = run()
    return out, log.routes


def _on_card_routing(card_run, host_run):
    """``card_run()`` and ``host_run()`` (the same work on the CPU) under
    routing logs.  Where the CPU's router picks the card's experts in every
    call, the two results; else the CPU runs again replaying the card's
    routing (a flip moves the token's output, and through attention the
    later tokens', so the free run's later flips follow from its first),
    and each token where its router's own choice differs must lie at a
    near tie: the CPU's K-th and (K+1)-th probabilities within
    ``MOE_FLIP_MARGIN`` and within twice the two sides' largest probability
    difference for the token (rounding alone parts them no further)."""
    got, card = _routed(card_run)
    want, host = _routed(host_run)
    sets = [[r["gate_idx"].sort(-1).values for r in rs] for rs in (card, host)]
    if all(torch.equal(a, b) for a, b in zip(*sets, strict=True)):
        return got, want
    want, host = _routed(host_run, replay=[c["gate_idx"] for c in card])
    for c, h in zip(card, host, strict=True):
        k = c["gate_idx"].shape[-1]
        differ = (c["gate_idx"].sort(-1).values != h["gate_idx"].sort(-1).values).any(-1)
        noise = (c["probs"] - h["probs"]).abs().amax(-1)
        top = h["probs"].sort(-1, descending=True).values
        margin = top[..., k - 1] - top[..., k]
        assert bool((margin[differ] <= MOE_FLIP_MARGIN).all())
        assert bool((margin[differ] <= 2 * noise[differ]).all())
    return got, want


def _moe_inputs(dev, n_tok, d, e, f, router):
    g = torch.Generator(device=dev).manual_seed(n_tok + e)
    x = torch.randn(1, n_tok, d, generator=g, device=dev).to(torch.bfloat16)
    r = (torch.zeros(d, e, device=dev) if router == "zeros" else
         torch.randn(d, e, generator=g, device=dev) / d**0.5)
    ws = [(torch.randn(shape, generator=g, device=dev) * shape[1] ** -0.5).to(torch.bfloat16)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    return x, r, ws


@pytest.mark.parametrize("n_tok,d,e,f,k", [
    (512, 2048, 64, 1408, 6),   # DeepSeek-MoE-16B's prefill of 512 tokens
    (16, 2048, 64, 1408, 6),    # its 16-slot decode step
    (512, 4096, 128, 1536, 8),  # Qwen3-MoE-235B's prefill
])
@pytest.mark.parametrize("router", ["zeros", "seeded"])
def test_moe_ffn_on_card_equals_cpu(dev, n_tok, d, e, f, k, router):
    """``moe_ffn`` at the MoE models' widths on the card against its CPU
    run: routing flips only at near ties (the router's inputs are the same
    bf16 values on both sides; its f32 products sum in other orders),
    outputs within 2 % of
    the largest (bf16 products rounded at other places), aux within 1e-5
    of itself.  The router of zeros ties every expert: the card's stable
    sort takes experts 0..K-1, as ``jax.lax.top_k`` does."""
    x, r, ws = _moe_inputs(dev, n_tok, d, e, f, router)
    (got, aux), (want, want_aux) = _on_card_routing(
        lambda: moe.moe_ffn(x, r, *ws, k),
        lambda: moe.moe_ffn(x.cpu(), r.cpu(), *[w.cpu() for w in ws], k))
    if router == "zeros":
        (_, _), routes = _routed(lambda: moe.moe_ffn(x, r, *ws, k))
        assert bool((routes[0]["gate_idx"] == torch.arange(k)).all())
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.02 * scale,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("router", ["zeros", "seeded"])
def test_moe_ffn_card_runs_are_bit_equal(dev, router):
    """Two card runs of DeepSeek's prefill-sized ``moe_ffn`` give the same
    bits: the combine adds each token's parts in a fixed order."""
    x, r, ws = _moe_inputs(dev, 512, 2048, 64, 1408, router)
    first = moe.moe_ffn(x, r, *ws, 6)
    second = moe.moe_ffn(x, r, *ws, 6)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_moe_lm_serving_on_card_equals_cpu(dev):
    """DeepSeek-MoE-16B's widths at 2 layers (seeded router) with the flash
    kernel: the card's prefill and teacher-forced decode logits against
    the CPU's within 0.1 (bf16 logits below 8), the CPU replaying the
    card's routing where the two parted (each flip at a near tie); the
    server runs
    every request and launches flash once a layer a prefill."""
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b").config, n_layers=2,
                              attn_impl="flash")
    card = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    card["layers"]["router"] = torch.randn(card["layers"]["router"].shape, generator=g,
                                           device=dev) / cfg.d_model**0.5
    host = _to(card, "cpu")
    prompt = torch.arange(2, 40).reshape(1, -1)
    tokens = [5, 77, 1234]

    def logits_of(p):
        d = p["embed"].device
        out, cache = lm.prefill(p, cfg, prompt.to(d))
        arena = lm.init_cache(cfg, 1, 64, device=d)
        for key in arena:
            arena[key][:, :, :prompt.shape[1]] = cache[key]
        seq = [out[0, -1].float().cpu()]
        for i, tok in enumerate(tokens):
            out, arena = lm.decode_step(p, cfg, arena, torch.tensor([tok], device=d),
                                        prompt.shape[1] + i)
            seq.append(out[0].float().cpu())
        return torch.stack(seq)

    got, want = _on_card_routing(lambda: logits_of(card), lambda: logits_of(host))
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)
    before = ops.LAUNCHES["flash_attention"]
    eng = ServeEngine(card, cfg, n_slots=2, max_len=64, eos_id=-1)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=list(range(2, 10 + i)), max_new=4))
    assert len(eng.run()) == 3
    assert ops.LAUNCHES["flash_attention"] == before + 3 * cfg.n_layers


def test_fm_on_card_equals_cpu(dev):
    cfg = dataclasses.replace(get_arch("fm").reduced, use_pallas=True)
    params = recsys.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.rows_per_field, (64, cfg.n_fields)).astype(np.int32))
    want = recsys.serve_step(params, cfg, {"ids": ids})
    before = ops.LAUNCHES["fm_interact"]
    got = recsys.serve_step(_to(params, dev), cfg,
                            {"ids": ids.to(dev)})
    assert ops.LAUNCHES["fm_interact"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _close_to_sum(got, want, abs_sum, rel):
    """|got - want| within ``rel`` of the sum of absolute values summed:
    the bound on two f32 sums of the same terms in different orders."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= rel * abs_sum.float() + 1e-6).all()), float(err.max())


@pytest.mark.parametrize("e,n,k,skew", [
    (100_000, 5_000, 70, True),    # GatedGCN's width, one segment of a third
    (100_000, 5_000, 1, True),     # degree counts
    (50_000, 20_000, 75, False),   # PNA's width, many empty segments
    (3_000, 40, 200, False),       # wider than the kernel's 128 register columns
    (1, 3, 8, False),
    (0, 3, 8, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum(dev, e, n, k, skew, dtype):
    rng = np.random.default_rng(e + n + k)
    seg = rng.integers(-2, n + 2, e).astype(np.int32)  # some out of range
    if skew:
        seg[rng.random(e) < 1 / 3] = 17
    seg_t = torch.from_numpy(seg).to(dev)
    x = torch.from_numpy(rng.normal(size=(e, k)).astype(np.float32)).to(dev).to(dtype)
    plan = ops.segment_plan(seg_t, n)
    before = ops.LAUNCHES["segment_sum"]
    got = ops.segment_sum(x, seg_t, n, plan=plan)
    again = ops.segment_sum(x, seg_t, n, plan=plan)
    assert ops.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits every run
    want = ref.segment_sum(x, seg_t, n)
    abs_sum = ref.segment_sum(x.float().abs(), seg_t, n)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7  # one bf16 rounding apart
    assert got.dtype == dtype and got.shape == (n, k)
    _close_to_sum(got, want, abs_sum, rel)
    assert torch.equal(ops.segment_sum(x, seg_t, n), got)  # the plan built inside


@pytest.mark.parametrize("pattern", SEGMENT_PATTERNS)
@pytest.mark.parametrize("k", [1, 2, 8, 70, 75, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_patterns(dev, pattern, k, dtype):
    """A hub of 40 % of 200,000 rows spread over many warps and blocks,
    even ids, mostly empty segments with ids out of range, one segment:
    the same bits on two calls, and within f32 sums in another order of the
    plain version (one bf16 rounding apart in bf16)."""
    x, seg = segment_case(pattern, 200_000, 20_000, k, seed=k)
    xt = torch.from_numpy(x).to(dev).to(dtype)
    seg_t = torch.from_numpy(seg).to(dev)
    plan = ops.segment_plan(seg_t, 20_000)
    got = ops.segment_sum(xt, seg_t, 20_000, plan=plan)
    assert torch.equal(got, ops.segment_sum(xt, seg_t, 20_000, plan=plan))
    _close_to_sum(got, ref.segment_sum(xt, seg_t, 20_000),
                  ref.segment_sum(xt.float().abs(), seg_t, 20_000),
                  1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("e,n,k", [(20, 5, 70), (20, 5, 1), (31, 2, 8),
                                   (1000, 100_000, 70), (1000, 100_000, 1)])
def test_segment_sum_few_rows(dev, e, n, k):
    """Fewer rows than one warp's range, and far more segments than rows
    (most of the output is the zeros of empty segments)."""
    x, seg = segment_case("uniform", e, n, k, seed=e)
    xt, seg_t = torch.from_numpy(x).to(dev), torch.from_numpy(seg).to(dev)
    got = ops.segment_sum(xt, seg_t, n)
    _close_to_sum(got, ref.segment_sum(xt, seg_t, n), ref.segment_sum(xt.abs(), seg_t, n),
                  1e-5)


def test_segment_sum_unaligned_rows(dev):
    """x one value past an aligned start: the kernel's vector loads fall
    back to narrower ones."""
    x, seg = segment_case("hub", 10_000, 500, 70, seed=9)
    flat = torch.from_numpy(np.concatenate([[0.0], x.reshape(-1)]).astype(np.float32))
    xt = flat.to(dev)[1:].view(10_000, 70)
    seg_t = torch.from_numpy(seg).to(dev)
    _close_to_sum(ops.segment_sum(xt, seg_t, 500), ref.segment_sum(xt, seg_t, 500),
                  ref.segment_sum(xt.abs(), seg_t, 500), 1e-5)


@pytest.mark.parametrize("b,f,v,k", [(4096, 39, 100_000, 1), (1, 39, 100_000, 10),
                                     (1000, 26, 5000, 16), (64, 3, 50, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag(dev, b, f, v, k, dtype):
    rng = np.random.default_rng(b + f + k)
    ids = rng.integers(0, v, (b, f)).astype(np.int32)
    ids[rng.random((b, f)) < 0.05] = rng.choice([-1, v, v + 7, -(1 << 30)])
    ids_t = torch.from_numpy(ids).to(dev)
    table = torch.from_numpy(rng.normal(size=(v, k)).astype(np.float32)).to(dev).to(dtype)
    before = ops.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(ids_t, table)
    assert ops.LAUNCHES["embedding_bag"] == before + 1
    want = ref.embedding_bag(ids_t, table)
    abs_sum = ref.embedding_bag(ids_t, table.float().abs())
    assert got.dtype == dtype and got.shape == (b, k)
    _close_to_sum(got, want, abs_sum, 1e-5 if dtype == torch.float32 else 2 ** -7)


def _check_bag(ids, table):
    """The kernel against its plain version (1e-5 of each value's sum of
    |terms| in f32, 2^-7 in bf16), the same bits on two calls.  The
    wrapper counts one launch a call, also where the swept route launches
    its kernel once per group of 8 fields."""
    before = ops.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(ids, table)
    assert ops.LAUNCHES["embedding_bag"] == before + 1
    assert torch.equal(got, ops.embedding_bag(ids, table))
    assert got.dtype == table.dtype and got.shape == (ids.shape[0], table.shape[1])
    _close_to_sum(got, ref.embedding_bag(ids, table),
                  ref.embedding_bag(ids, table.float().abs()),
                  1e-5 if table.dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("b,f,k", [*BAG_SHAPES, (100_003, 39, 1)])
@pytest.mark.parametrize("pattern", BAG_PATTERNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_edges(dev, b, f, k, pattern, dtype):
    """The edges of the narrow route (one bag, a bag past or short of a
    block, 1 to 500 fields, ids banded by field or off the table) and of
    the wide route (the retrieval query, K > 32)."""
    ids, table = bag_case(pattern, b, f, 50_000, k, seed=b + f + k)
    _check_bag(torch.from_numpy(ids).to(dev), torch.from_numpy(table).to(dev).to(dtype))


@pytest.mark.parametrize("b,f,k", [(30_000, 39, 1), (10_000, 39, 3)])
@pytest.mark.parametrize("pattern", BAG_PATTERNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_sweep(dev, b, f, k, pattern, dtype):
    """Over a million lookups into a table of more than 32 MB: an f32
    bag is swept a group of 8 fields a launch, each adding to the sums of
    the one before (a bf16 bag takes one launch)."""
    ids, table = bag_case(pattern, b, f, 9_000_000 // k, k, seed=b + k)
    _check_bag(torch.from_numpy(ids).to(dev), torch.from_numpy(table).to(dev).to(dtype))


@pytest.mark.parametrize("k", [1, 10])
def test_embedding_bag_unaligned(dev, k):
    """ids one value past an aligned start, and a table one value past
    one (the wide route's rows in narrower vectors)."""
    ids, table = bag_case("banded", 1000, 39, 20_000, k, seed=k)
    flat_ids = torch.from_numpy(np.concatenate([[0], ids.reshape(-1)]).astype(np.int32))
    flat_tab = torch.from_numpy(np.concatenate([[0.0], table.reshape(-1)]).astype(np.float32))
    _check_bag(flat_ids.to(dev)[1:].view(1000, 39), flat_tab.to(dev)[1:].view(20_000, k))


@pytest.mark.parametrize("name", ["gatedgcn", "pna"])
def test_gnn_on_card_equals_cpu(dev, name):
    """Full width, 2 layers, on a random graph of 2,000 nodes: the card's
    logits equal the CPU's within 1e-4, two card runs are bit-equal, and
    every segment sum goes through the kernel."""
    mod = {"gatedgcn": gatedgcn, "pna": pna}[name]
    cfg = dataclasses.replace(get_arch(name).config, n_layers=2)
    graph = random_graph(np.random.default_rng(0), 2000, 8000, cfg.d_in, cfg.n_classes)
    params = mod.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = mod.forward(params, cfg, graph_to(graph, "cpu"))
    card = _to(params, dev)
    before = ops.LAUNCHES["segment_sum"]
    got = mod.forward(card, cfg, graph_to(graph, dev))
    again = mod.forward(card, cfg, graph_to(graph, dev))
    per_forward = 2 * cfg.n_layers if name == "gatedgcn" else 8 * cfg.n_layers + 1
    assert ops.LAUNCHES["segment_sum"] == before + 2 * per_forward
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_dedup_graph_on_card_equals_cpu(dev):
    facts, program, dic = generate(**PROFILES["opencyc_like"])
    _, rep, _ = TorchEngine(dic.n_resources, device=dev).materialise(facts, program)
    graph = build_graph_from_kg(facts, dic.n_resources, 16, np.random.default_rng(0))
    card = dedup_graph(graph, rep, dev)
    host = dedup_graph(graph, rep, "cpu")
    for key in host:
        assert torch.equal(card[key].cpu(), host[key]), key


def _serve_case(seed: int = 3):
    kw = dict(n_groups=2, group_size=3, n_spokes_per=2, n_plain=60,
              hierarchy_depth=2, chain_rules=True, seed=seed)
    facts, program, dic = generate(**kw)
    trace = sample_update_stream(facts, dic, n_events=8, batch=8, p_query=0.5,
                                 seed=seed)
    assert {"add", "delete", "query"} <= {op for op, _ in trace}
    return facts, program, dic, trace


_SNAP = ("d_triples", "d_keys", "d_triples_pos", "d_keys_pos")


def _serve_store(facts, program, dic, device, **kw):
    from repro_torch.serve import TripleStore

    # at 2^14 an update's delta width differs from the base run's stream
    # width, so the worker captures a round graph of its own
    cap = 1 << 14
    eng = TorchEngine(dic.n_resources, device=device, capacity=cap, bind_cap=cap,
                      out_cap=cap, rewrite_cap=cap)
    return TripleStore(facts, program, dic, engine=eng, **kw)


def _published(store) -> list:
    """Every snapshot the store publishes from now on, with copies of its
    device arrays taken at publication."""
    out = [(store.snapshot, {k: getattr(store.snapshot, k).clone() for k in _SNAP})]
    inner = store._publish

    def publish():
        snap = inner()
        out.append((snap, {k: getattr(snap, k).clone() for k in _SNAP}))
        return snap

    store._publish = publish
    return out


def test_serving_store_on_card_equals_cpu(dev):
    """The cooperative store on the card equals it on the CPU: every
    published snapshot bit for bit (the four arrays over their padded
    length, n_live, rho), every answer and epoch, the batched drain against
    the host path; the publication launches dedup_order and the drain the
    search's prefix form; no published snapshot changes after it was
    published."""
    facts, program, dic, trace = _serve_case()
    card, host = (_serve_store(facts, program, dic, d) for d in (dev, "cpu"))
    pubs = [_published(s) for s in (card, host)]
    rng = np.random.default_rng(0)
    tickets = ([], [])
    for op, payload in trace:
        for store, tk in zip((card, host), tickets):
            if op == "query":
                tk.append(store.submit_query(payload))
            else:
                store.submit_update(op, payload)
        for _ in range(int(rng.integers(0, 3))):
            card.step()
            host.step()
    card.drain()
    host.drain()
    assert len(pubs[0]) == len(pubs[1]) > 1
    for (cs, cclone), (hs, _) in zip(*pubs):
        assert (cs.epoch, cs.n_live) == (hs.epoch, hs.n_live)
        for k in _SNAP:
            assert getattr(cs, k).device.type == "cuda"
            assert torch.equal(getattr(cs, k).cpu(), getattr(hs, k)), k
            assert torch.equal(getattr(cs, k), cclone[k]), f"snapshot {cs.epoch} {k}"
        np.testing.assert_array_equal(cs.rho.rep, hs.rho.rep)
    for a, b in zip(*tickets):
        assert (a.epoch, a.answer) == (b.epoch, b.answer)
    queries = [q for op, q in trace if op == "query"] * 3
    queries += [Query([(int(s), int(p), -1)], [], [-1], False) for s, p, _ in facts[:16]]
    drained = [[store.submit_query(q) for q in queries] for store in (card, host)]
    card.drain()
    host.drain()
    for a, b, q in zip(*drained, queries):
        assert (a.epoch, a.answer) == (b.epoch, b.answer)
        assert a.answer == evaluate_at(q, card.snapshot, dic)[0]
    assert card._batched.stats["batched"] > 0
    by_phase = card.launch_counts["by_phase"]
    assert by_phase.get("query/prefix_range_bounds", 0) > 0
    assert by_phase.get("publish/dedup_order", 0) >= len(pubs[0])
    assert host.launch_counts["total"] == 0  # the CPU launches nothing
    assert card.audit() == [] and host.audit() == []


def test_threaded_store_on_card_answers_while_worker_captures(dev):
    """A threaded store on the card: the worker captures its first round
    and wave graphs while this thread answers queries against the
    published snapshot (each capture is held open until this thread has
    answered a few); every answer equals the CPU store's at its epoch, and
    the final state equals the cooperative CPU store's."""
    import threading

    from repro_torch.core import fused

    facts, program, dic, trace = _serve_case()
    updates = [(op, p) for op, p in trace if op != "query"]
    queries = [q for op, q in trace if op == "query"]
    queries += [Query([(int(s), int(p), -1)], [], [-1], False) for s, p, _ in facts[:8]]
    host = _serve_store(facts, program, dic, "cpu")
    host_pub = _published(host)
    for op, payload in updates:
        host.submit_update(op, payload)
    host.drain()
    want = {snap.epoch: snap for snap, _ in host_pub}
    store = _serve_store(facts, program, dic, dev, threaded=True)
    pub = _published(store)
    capturing, release = threading.Event(), threading.Event()
    held = []
    inner = fused._Captured._capture

    def held_capture(self):
        body = self._body

        def body_held():
            if torch.cuda.is_current_stream_capturing() and self.key[0] not in held:
                held.append(self.key[0])
                capturing.set()
                assert release.wait(120), "the main thread never released the capture"
                release.clear()
            body()

        self._body = body_held
        try:
            inner(self)
        finally:
            del self._body

    answered, matched_in_capture = [], 0
    try:
        fused._Captured._capture = held_capture
        for op, payload in updates:
            store.submit_update(op, payload)
        while store.pending():
            held_now = capturing.wait(0.01)
            before = store._batched.stats["batched"]
            # a burst drained by query_now: its shape groups run on the card
            answered += [store.submit_query(q) for q in queries[:-1]]
            answered.append(store.query_now(queries[-1]))
            if held_now:  # the worker's capture is open
                matched_in_capture += store._batched.stats["batched"] - before
                capturing.clear()
                release.set()
            store._worker.check()
        store.drain()
    finally:
        fused._Captured._capture = inner
        release.set()
        store.close()
    assert sorted(held) == ["round", "wave"]
    assert store.engine.dispatches.compiles.get("fforward", 0) >= 1
    assert store.engine.dispatches.compiles.get("fwave", 0) >= 1
    assert matched_in_capture > 0
    for t in answered:
        assert t.answer == evaluate_at(t.query, want[t.epoch], dic)[0]
    for snap, clone in pub:
        for k in _SNAP:
            assert torch.equal(getattr(snap, k), clone[k])
            assert torch.equal(getattr(snap, k).cpu(), getattr(want[snap.epoch], k))
    assert store.epoch == host.epoch == len(updates)


# the entry points each family's units launch at the pex probe (PERF.md §6:
# REW's round and the host loop's step run all five REW kernels, the
# publication and the index rebuild the sort, the matcher the prefix search)
_AUDIT_LAUNCHES = {
    "bgp": ["prefix_range_bounds"], "extract_od": ["search_bounds"],
    "fforward": ["dedup_order", "rewrite_triples", "search_bounds",
                 "uf_compress", "uf_union"],
    "finalize_tombs": ["search_bounds"],
    "fwave": ["dedup_order", "rewrite_triples", "search_bounds"],
    "member": ["search_bounds"], "mplan": ["search_bounds"], "occupancy": [],
    "od": ["dedup_order", "rewrite_triples", "search_bounds"],
    "plan": ["search_bounds"],
    "process": ["dedup_order", "rewrite_triples", "search_bounds",
                "uf_compress", "uf_union"],
    "rebuild_index": ["dedup_order"],
    "rplan": ["prefix_range_bounds", "search_bounds"],
    "seed_tombs": ["search_bounds"], "snapshot": ["dedup_order"],
    "squeeze": ["search_bounds"],
}


def test_audit_on_card(dev):
    """The trace audit at the pex probe on the card: no violation (the
    recorded list is empty), the driven stream reconciles with the static
    phase profile, and the launch records hold each family's kernels."""
    from repro_torch.analysis import run_report

    report = run_report("pex", device="cuda")
    assert report["device"].startswith("cuda")
    assert report["violations"] == []
    assert report["dispatch"]["problems"] == []
    assert report["launches"] == _AUDIT_LAUNCHES


@pytest.mark.parametrize("name", ["arena_sort", "arena_scatter", "int32_key",
                                  "host_callback", "nested_cond_sort"])
def test_fixture_trips_expected_pass_on_card(dev, name):
    """Each planted fixture trips its pass and only it on the card too: the
    nested sort as the dedup_order kernel's launch."""
    from repro_torch.analysis import ALL_PASSES
    from repro_torch.analysis.fixtures import EXPECTED_PASS, trace_fixture

    label, trace, rows = trace_fixture(name, device="cuda")
    fired = {v.pass_name: v for p in ALL_PASSES for v in p.run(label, trace, rows)}
    assert set(fired) == {EXPECTED_PASS[name]}
    if name == "nested_cond_sort":
        assert (fired["NoArenaSort"].primitive, fired["NoArenaSort"].path) == \
            ("dedup_order", "launch")


# ---------------------------------------------------------------------------
# training: the backward through the segment-sum kernel, the kernels without
# a backward, a GNN step and a checkpoint of card tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 70])
def test_segment_sum_and_gather_rows_backward(dev, k):
    """On a hub-skewed index with ids out of range: the gradient of
    ``segment_sum`` (a row gather) equals its plain version's exactly; the
    gradient of ``gather_rows`` (the kernel) equals torch's autograd of
    ``x[idx]`` on the CPU within f32 sums in another order; both launch the
    kernel as counted and give the same bits on two runs."""
    rng = np.random.default_rng(k)
    n, e = 5_000, 100_000
    seg = rng.integers(-2, n + 2, e).astype(np.int32)
    seg[rng.random(e) < 1 / 3] = 17
    seg_t = torch.from_numpy(seg).to(dev)
    x = torch.from_numpy(rng.normal(size=(e, k)).astype(np.float32))
    go = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    plan = ops.segment_plan(seg_t, n)
    runs = []
    for _ in range(2):
        xc = x.to(dev).requires_grad_(True)
        out = ops.segment_sum(xc, seg_t, n, plan)
        runs.append(torch.autograd.grad(out, xc, go.to(dev))[0])
    assert torch.equal(runs[0], runs[1])
    xh = x.clone().requires_grad_(True)
    want = torch.autograd.grad(ref.segment_sum(xh, torch.from_numpy(seg), n), xh, go)[0]
    assert torch.equal(runs[0].cpu(), want)

    idx = np.clip(seg, 0, n - 1).astype(np.int32)
    idx_t = torch.from_numpy(idx).to(dev)
    iplan = ops.segment_plan(idx_t, n)
    table = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(e, k)).astype(np.float32))
    before = ops.LAUNCHES["segment_sum"]
    runs = []
    for _ in range(2):
        tc = table.to(dev).requires_grad_(True)
        out = ops.gather_rows(tc, idx_t, iplan)
        assert torch.equal(out.detach().cpu(), table[torch.from_numpy(idx).long()])
        runs.append(torch.autograd.grad(out, tc, g.to(dev))[0])
    assert ops.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(runs[0], runs[1])
    th = table.clone().requires_grad_(True)
    want = torch.autograd.grad(th[torch.from_numpy(idx).long()], th, g)[0]
    abs_sum = ref.segment_sum(g.abs(), torch.from_numpy(idx), n)
    _close_to_sum(runs[0].cpu(), want, abs_sum, 1e-5)


def test_kernels_without_a_backward_raise_under_grad(dev):
    """Flash attention, the FM interaction and the embedding bag raise on
    the card when autograd would need their gradient, and run under
    ``torch.no_grad()``."""
    q = torch.randn(1, 16, 2, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 16, 2, 64, device=dev)
    x = torch.randn(8, 4, 10, device=dev, requires_grad=True)
    ids = torch.randint(0, 50, (8, 4), dtype=torch.int32, device=dev)
    table = torch.randn(50, 10, device=dev, requires_grad=True)
    calls = (lambda: ops.flash_attention(q, k, k), lambda: ops.fm_interact(x),
             lambda: ops.embedding_bag(ids, table))
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.parametrize("name", ["gatedgcn", "pna", "egnn", "dimenet"])
def test_gnn_train_step_on_card_equals_cpu(dev, name):
    """One loss and gradient of each GNN (full width, 2 layers or blocks)
    on the card against the CPU, the same weights: the loss within 1e-5
    relative, each gradient leaf within 1e-3 of its largest CPU value (f32
    sums in other orders, as the CPU tests' tolerance against the
    reference).  PNA's max and min pick one message a (node, feature), and
    at a near tie rounding can pick another on the card than on the CPU,
    which moves that gradient to another edge: 31 of a leaf's 11,250
    entries, up to 3.8e-3 of its largest value, on an H100; so PNA's
    leaves are held by their relative L2 error, within 1e-3.  Two card
    runs bit-equal but PNA's, whose max and min backward is torch's
    ``scatter_reduce`` (checked for equality to 1e-6 only)."""
    from repro_torch.data.pipeline import molecule_batch
    from repro_torch.models.gnn import dimenet, egnn

    mod = {"gatedgcn": gatedgcn, "pna": pna, "egnn": egnn, "dimenet": dimenet}[name]
    depth = "n_blocks" if name == "dimenet" else "n_layers"
    cfg = dataclasses.replace(get_arch(name).config, **{depth: 2})
    if name in ("egnn", "dimenet"):
        batch = molecule_batch(np.random.default_rng(0), 16, 30, 64)
    else:
        batch = random_graph(np.random.default_rng(0), 2000, 8000, cfg.d_in, cfg.n_classes)
    params = mod.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def step(p, d):
        flat, spec = torch.utils._pytree.tree_flatten(_to(p, d))
        leaves = [t.requires_grad_(True) for t in flat]
        loss = mod.loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec), cfg,
                           graph_to(batch, d))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, grads)]

    host = step(params, "cpu")
    card = [step(params, dev) for _ in range(2)]
    torch.testing.assert_close(card[0][0].cpu(), host[0], rtol=1e-5, atol=0)
    for g, h in zip(card[0][1], host[1]):
        if name == "pna":
            assert float((g.cpu() - h).norm()) <= 1e-3 * float(h.norm()) + 1e-12
        else:
            torch.testing.assert_close(g.cpu(), h, rtol=0,
                                       atol=1e-3 * float(h.abs().max()) + 1e-12)
    for a, b in zip(card[0][1], card[1][1]):
        if name == "pna":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b)


def test_checkpoint_of_card_tensors(dev, tmp_path):
    """The async writer snapshots card tensors at the call (later writes on
    the card's stream do not reach the file), and a restore puts each leaf
    back on the card, bf16 included."""
    from repro_torch.ckpt import CheckpointManager, restore_checkpoint

    tree = {"w": torch.randn(512, 512, device=dev),
            "b": torch.randn(300, device=dev).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    want = {k: v.clone() for k, v in tree.items()}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, tree, aux={"next_step": 1})
    for _ in range(20):
        tree["w"].mul_(2.0).add_(1.0)
    mgr.wait()
    mgr.close()
    out, aux, step = restore_checkpoint(str(tmp_path), tree)
    assert (aux, step) == ({"next_step": 1}, 1)
    for k in want:
        assert out[k].device == tree[k].device and out[k].dtype == want[k].dtype
        assert torch.equal(out[k], want[k])


ROUND_MARKS = ("rew.merge", "rew.sweep", "rew.dedup", "rew.join", "rew.flags",
               "body.end")
WAVE_MARKS = ("maint.tomb_join", "maint.od_step", "body.end")


def _profiled(fn):
    """``fn()`` under torch.profiler; its device kernels' names and every
    host event's name, each in time order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted(prof.events(), key=lambda e: e.time_range.start)
    device = [e.name for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    return device, [e.name for e in evs if e.device_type != torch.autograd.DeviceType.CUDA]


def _marks(names):
    """The stages of the marker kernels among ``names``, in order: the
    instance of ``span_mark_kernel`` named after each of ``spans.MARKS``
    (``rew.sweep`` -> ``span_mark_kernel<rew::sweep>``)."""
    from repro_torch.core.spans import MARKS

    kernel = {f"span_mark_kernel<{m.replace('.', '::')}>": m for m in MARKS}
    return [m for n in names for k, m in kernel.items() if k in n]


def _run_stream(eng, facts, program, events):
    state = eng.materialise_state(facts, program)
    for op, delta in events:
        (eng.add_facts if op == "add" else eng.delete_facts)(state, delta)
    return state


def test_span_markers_replay_in_stage_order(dev):
    """With the spans on, the captured round and wave graphs record their
    stage markers, and a replay runs them in stage order on the device:
    every round of a rerun is one replay of the round's six markers; the
    sort counter counts the rerun's sorted keys."""
    from repro_torch.core import spans

    facts, program, n_res, events = _update_stream(n_events=6, seed=1)
    spans.enable(True)
    try:
        eng = TorchEngine(n_res, device=dev)
        _run_stream(eng, facts, program, events)
        graphs = eng.captured_graphs()
        assert {g["family"] for g in graphs} == {"fforward", "fwave"}
        for g in graphs:
            assert g["stages"] == (ROUND_MARKS if g["family"] == "fforward" else WAVE_MARKS)
        device, host = _profiled(lambda: eng.materialise_state(facts, program))
        split = eng.last_split
    finally:
        spans.enable(False)
    rounds = len(split["rounds"])
    assert rounds >= 2 and all(r["reads"] == 1 for r in split["rounds"])
    assert _marks(device) == list(ROUND_MARKS) * rounds
    assert "rew.materialise" in host and "rew.round" in host
    assert 0 < split["sort_pad_keys"] < split["sort_keys"]


def test_graphs_captured_with_spans_off_hold_no_marker(dev):
    """With the spans off, a materialisation and a delete under the
    profiler show no program span and no marker, and every graph records
    the launches a graph captured with the spans on records."""
    facts, program, n_res, events = _update_stream(n_events=6, seed=1)
    off = TorchEngine(n_res, device=dev)
    _run_stream(off, facts, program, events)
    delete = next(d for op, d in events if op == "delete")

    def rerun():
        st = off.materialise_state(facts, program)
        off.delete_facts(st, delete)

    device, host = _profiled(rerun)
    assert _marks(device) == [] and not any("span_mark" in n for n in device)
    assert not any(n.startswith(("rew.", "maint.")) for n in host)
    assert "sort_keys" not in off.last_split
    from repro_torch.core import spans

    spans.enable(True)
    try:
        on = TorchEngine(n_res, device=dev)
        _run_stream(on, facts, program, events)
    finally:
        spans.enable(False)
    calls_off = {(g["family"], g["key"]): (g["calls"], g["stages"])
                 for g in off.captured_graphs()}
    calls_on = {(g["family"], g["key"]): g["calls"] for g in on.captured_graphs()}
    assert set(calls_on) <= set(calls_off) and calls_on
    for k, calls in calls_on.items():
        assert calls_off[k] == (calls, ())
