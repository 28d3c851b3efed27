"""The dry run (``repro_torch.launch.dryrun``), its counts and the roofline.

Each case joins a ``fake`` process group of the mesh's size as one rank
(``dryrun.fake_group``, destroyed when the case ends, so no other test in
the worker sees it) and counts one step of a cell on fake tensors.

* Phase 11 (a) of ``chip_smoke.py`` (Qwen2-1.5B at 8 layers, 2 x 1,024
  tokens, (data 2, model 2)): the collectives counted a step equal the
  ones measured on an H100 (PERF.md §6): ``model:all_reduce`` 44 calls
  and 132 MB, ``data:reduce_scatter`` 608 MB, ``data:all_gather`` 304 MB.
* ``qwen2-reduced`` at (data 2, model 2): the products' FLOPs summed over
  the four ranks equal the count at one rank, and for the prefill that
  count equals the hand formula below.
* The bytes of the inputs counted live (parameters, moments, batch) equal
  the sum of their ``shard_shape`` blocks' bytes exactly.
* ``build_cell`` builds every (arch, shape) of every family on both
  production meshes.
* One cell a family through ``run_cell`` at world 256 on the reduced
  configs, and the roofline table made from those records.
* Under the counter a kernel wrapper takes its card branch: its scratch,
  the plan it builds, and each launch booked by ``KERNEL_COUNTS``.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import count_cell, fake_group, run_cell
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.launch.sharding import shard_shape
from repro_torch.launch.workloads import build_cell


def _count(spec, shape, mesh_shape, rank=0) -> dict:
    with fake_group(math.prod(mesh_shape), rank):
        mesh = make_mesh(mesh_shape, ("data", "model")[-len(mesh_shape):])
        return count_cell(spec, shape, mesh)


def test_phase11a_collectives_equal_the_card():
    spec = get_arch("qwen2-1.5b")
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, n_layers=8))
    rec = _count(spec, ShapeSpec("train_2x1024", "train", dict(global_batch=2, seq_len=1024)),
                 (2, 2))
    got = rec["collectives"]["by_kind"]
    print({k: v for k, v in got.items()})
    assert got["model:all_reduce"]["count"] == 44
    # PERF.md prints the card's bytes a step in MB, rounded
    for key, mb in (("model:all_reduce", 132), ("data:reduce_scatter", 608),
                    ("data:all_gather", 304)):
        assert round(got[key]["bytes"] / 1e6) == mb, (key, got[key])


def _qwen2_reduced():
    spec = get_arch("qwen2-1.5b")
    return dataclasses.replace(spec, config=spec.reduced)


def _prefill_flops(cfg, b: int, s: int) -> float:
    """The prefill's products by hand: per layer q, k, v and o, the
    attention's scores and P.V over one key chunk (the chunked path pads
    the keys to ``attn_chunk``), the SwiGLU's three; then the last
    position's logits."""
    d, hd, kvd, t = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head, cfg.attn_chunk
    per_layer = (2 * b * s * d * (hd + 2 * kvd) + 2 * b * s * hd * d
                 + 2 * (2 * b * cfg.n_heads * s * t * cfg.d_head)
                 + 3 * 2 * b * s * d * cfg.d_ff)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_summed_over_ranks_equal_one_rank(kind):
    spec = _qwen2_reduced()
    shape = ShapeSpec(f"{kind}_small", kind, dict(global_batch=4, seq_len=32))
    one = _count(spec, shape, (1, 1))["cost"]["flops_per_dev"]
    ranks = [_count(spec, shape, (2, 2), r)["cost"]["flops_per_dev"] for r in range(4)]
    print(kind, one, ranks)
    assert sum(ranks) == one
    if kind == "prefill":
        assert one == _prefill_flops(spec.config, 4, 32)


@pytest.mark.parametrize("case", ["qwen2", "qwen2+fsdp", "fm"])
def test_input_bytes_are_the_blocks(case):
    if case == "fm":
        spec = get_arch("fm")
        spec = dataclasses.replace(spec, config=spec.reduced)
        shape = ShapeSpec("train_small", "train", dict(batch=64))
    else:
        spec = _qwen2_reduced()
        if case.endswith("+fsdp"):
            spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, fsdp=True))
        shape = ShapeSpec("train_small", "train", dict(global_batch=4, seq_len=16))
    for rank in (0, 3):
        rec = _count(spec, shape, (2, 2), rank)
        cell = build_cell(spec, shape, abstract_mesh((2, 2), ("data", "model")))
        want = 0
        for sd, sh in zip(cell.input_specs, cell.in_shardings):
            for leaf, s in zip(_leaves(sd), _leaves(sh)):
                elem = torch.empty((), dtype=leaf.dtype).element_size()
                want += math.prod(shard_shape(leaf.shape, s)) * elem
        assert rec["memory"]["argument_bytes"] == want, (case, rank)
        assert rec["memory"]["peak_bytes"] >= want


def _leaves(tree):
    from repro_torch.compat import pytree

    return pytree.tree_leaves(tree)


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))])
def test_build_cell_builds_every_cell(mesh):
    m = abstract_mesh(*mesh)
    n = 0
    for arch in all_archs():
        spec = get_arch(arch)
        for shape in spec.shapes:
            cell = build_cell(spec, shape, m)
            assert cell.kind == shape.kind and cell.model_flops > 0, (arch, shape.name)
            n += 1
    assert n == 42


FAMILY_CELLS = [("qwen2-1.5b", "decode_32k"), ("gatedgcn", "full_graph_sm"),
                ("fm", "serve_bulk"), ("sameas_rew", "round_67m")]


def test_run_cell_one_a_family_and_roofline(tmp_path):
    recs = [run_cell(arch, shape, "single", str(tmp_path), reduced=True)
            for arch, shape in FAMILY_CELLS]
    for rec in recs:
        assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
        assert rec["coords"] == {"data": 0, "model": 0}
        assert rec["cost"]["bytes_per_dev"] > 0 and rec["memory"]["fits_hbm"]
    assert recs[0]["collectives"]["by_kind"]["model:all_reduce_max"]["count"] == \
        get_arch("qwen2-1.5b").reduced.n_layers  # one softmax merge a layer
    assert recs[3]["cost"]["kernel_launches"]["dedup_order"] > 0
    rows = [roofline.analyse(r) for r in roofline.load_cells(str(tmp_path))]
    assert len(rows) == 4 and all(r["memory_s"] > 0 for r in rows)
    table = roofline.markdown_table(rows, [])
    print(table)
    assert table.count("\n") == 5 and "qwen2-1.5b:decode_32k" in table


def test_counter_takes_the_wrappers_card_branch():
    """Under the counter a wrapper runs its card branch on fake CPU
    tensors, allocating what it allocates on the card: ``segment_sum``
    without a plan builds one (a sort and a search booked beside the sum),
    the sort zeroes its scratch of ``CARD_SIZES`` words and the sum takes
    its f32 carry; nothing is booked as a launch on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.launch.costs import CARD_SIZES, KERNEL_COUNTS, StepCounter

    before = dict(ops.LAUNCHES)
    counter = StepCounter()
    e, n, k = 1000, 50, 8
    with FakeTensorMode(), ops.traced(counter), counter:
        x = torch.empty(e, k)
        seg = torch.empty(e, dtype=torch.int32)
        out = ops.segment_sum(x, seg, n)
        assert tuple(out.shape) == (n, k)
    assert dict(counter.kernel["launches"]) == {"dedup_order": 1, "search_bounds": 1,
                                                "segment_sum": 1}
    assert ops.LAUNCHES == before
    made = {(m[3], m[0]) for m in counter._meta}
    assert ("zeros", 4 * CARD_SIZES["dedup_order_scratch_words"](e)) in made
    assert ("empty", 4 * 2 * k * CARD_SIZES["segment_sum_max_blocks"]()) in made
    want = sum(f(*a)[0] for f, a in (
        (KERNEL_COUNTS["dedup_order"], (torch.empty(e, dtype=torch.int64),)),
        (KERNEL_COUNTS["search_bounds"], (torch.empty(n + 1, dtype=torch.int64),
                                          torch.empty(e, dtype=torch.int64), 1)),
        (KERNEL_COUNTS["segment_sum"], (torch.empty(e, k), torch.empty(e, dtype=torch.int32), n))))
    assert counter.kernel["bytes"] == want
