"""The port's GNNs (``repro_torch.models.gnn``) and the sameAs-deduplicated
KG graph (``repro_torch.data.graphs``) against the reference on the CPU.

GatedGCN and PNA run on a ``random_graph`` made with numpy from a seed,
with the reference's weights carried over by ``params_from_numpy``, at the
reduced configs and at full width with 2 layers.  Everything is f32, and
the two packages sum in other orders (XLA's segment sums and matmuls
against torch's), so logits agree within ``TOL``.  Measured on these
inputs: GatedGCN 2.4e-6 at logits up to 5.1, PNA 2.6e-5 at logits up to
3.6.  PNA's error is the larger because its standard deviation
``sqrt(max(m2 - m^2, 0) + 1e-6)`` cancels: on a node of one in-edge m2 and
m^2 differ by about 1e-6 of m^2, so f32 keeps only a few bits of the
difference, and the attenuation scaler (3.6 there) carries it on.  The KG's deduplicated edge array equals the reference
example's procedure exactly.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.core.materialise import materialise  # noqa: E402
from repro.data.generator import PROFILES as REF_PROFILES, generate as ref_generate  # noqa: E402
from repro.data.pipeline import random_graph as ref_random_graph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.gnn import gatedgcn as jgatedgcn, pna as jpna  # noqa: E402
from repro_torch import TorchEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.generator import PROFILES, generate  # noqa: E402
from repro_torch.data.graphs import (  # noqa: E402
    build_graph_from_kg, dedup_graph, graph_to, random_graph,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.gnn import common, gatedgcn, pna  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = {"gatedgcn": (jgatedgcn, gatedgcn), "pna": (jpna, pna)}


def _configs(name):
    spec = ref_arch(name)
    # full width (d_hidden 70 / 75, d_in 1433, 40 classes), 2 layers
    return {"reduced": spec.reduced,
            "full_width": dataclasses.replace(spec.config, n_layers=2)}


@pytest.mark.parametrize("name", ["gatedgcn", "pna"])
@pytest.mark.parametrize("size", ["reduced", "full_width"])
def test_forward_matches_reference(name, size):
    jmod, mod = MODELS[name]
    jcfg = _configs(name)[size]
    cfg = type(get_arch(name).config)(**dataclasses.asdict(jcfg))
    n_nodes, n_edges = (40, 160) if size == "reduced" else (200, 800)
    graph = random_graph(np.random.default_rng(7), n_nodes, n_edges, jcfg.d_in,
                         jcfg.n_classes)
    jparams = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    want = np.asarray(jmod.forward(jparams, jcfg, {k: jnp.asarray(v)
                                                  for k, v in graph.items()}))
    got = mod.forward(params, cfg, graph_to(graph, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (n_nodes, jcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _example():
    """``examples/kg_dedup_gnn.py``, the reference's own KG-dedup-GNN
    integration, loaded as a module."""
    path = Path(__file__).resolve().parents[1] / "examples" / "kg_dedup_gnn.py"
    spec = importlib.util.spec_from_file_location("kg_dedup_gnn", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("which", ["random_graph", "build_graph_from_kg"])
def test_graph_builders_are_the_reference_copies(which):
    if which == "random_graph":
        ga = random_graph(np.random.default_rng(3), 30, 90, 8, 4)
        gb = ref_random_graph(np.random.default_rng(3), 30, 90, 8, 4)
    else:
        facts, _, dic = generate(**PROFILES["opencyc_like"])
        ga = build_graph_from_kg(facts, dic.n_resources, 16, np.random.default_rng(0))
        gb = _example().build_graph_from_kg(facts, dic.n_resources, 16,
                                            np.random.default_rng(0))
    assert ga.keys() == gb.keys()
    for k in ga:
        assert ga[k].dtype == gb[k].dtype
        np.testing.assert_array_equal(ga[k], gb[k])


def test_params_from_numpy_keeps_the_gnn_tree():
    """The reference's GNN tree (dicts, lists of layers, lists of (w, b)
    tuples) carries over with its structure and its values."""
    jparams = jgatedgcn.init_params(jax.random.PRNGKey(1),
                                    ref_arch("gatedgcn").reduced)
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, "cpu")
    assert isinstance(params["layers"], list) and isinstance(params["head"], list)
    assert isinstance(params["head"][0], tuple) and len(params["head"][0]) == 2
    flat_ref, def_ref = jax.tree.flatten(tree)
    flat, def_port = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), params,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert def_ref == def_port
    for a, b in zip(flat, flat_ref, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["gatedgcn", "pna"])
def test_forward_launches_through_the_segment_plan(name, monkeypatch):
    """A forward builds one plan of ``dst`` and one of ``src`` and hands
    the first to every segment sum (GatedGCN sums twice a layer, PNA eight
    times a layer and once for the degrees) and each to the gathers by its
    array (two a layer; their backward is the segment sum through it)."""
    _, mod = MODELS[name]
    cfg = get_arch(name).reduced
    graph = graph_to(random_graph(np.random.default_rng(2), 30, 120, cfg.d_in,
                                  cfg.n_classes), "cpu")
    plans, calls, gathers = [], [], []
    real_plan, real_sum, real_gather = ops.segment_plan, ops.segment_sum, ops.gather_rows

    def plan_spy(seg, n):
        plans.append(real_plan(seg, n))
        return plans[-1]

    def sum_spy(x, seg, n, plan=None):
        calls.append(plan)
        return real_sum(x, seg, n, plan=plan)

    def gather_spy(x, idx, plan=None):
        gathers.append((idx, plan))
        return real_gather(x, idx, plan)

    monkeypatch.setattr(ops, "segment_plan", plan_spy)
    monkeypatch.setattr(ops, "segment_sum", sum_spy)
    monkeypatch.setattr(ops, "gather_rows", gather_spy)
    mod.forward(mod.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
                cfg, graph)
    per_layer, extra = (2, 0) if name == "gatedgcn" else (8, 1)
    assert len(plans) == 2
    assert torch.equal(plans[0].seg, torch.sort(graph["edge_index"][1]).values)
    assert torch.equal(plans[1].seg, torch.sort(graph["edge_index"][0]).values)
    assert len(calls) == per_layer * cfg.n_layers + extra
    assert all(p is plans[0] for p in calls)
    assert len(gathers) == 2 * cfg.n_layers
    for idx, plan in gathers:
        assert plan is plans[0 if idx is graph["edge_index"][1] or
                             torch.equal(idx, graph["edge_index"][1]) else 1]


def test_segment_reductions_match_reference_on_a_skewed_graph():
    """mean, max, min, std, softmax and degrees of the port's common module
    against the reference's, with one node taking a third of the edges and
    some nodes none."""
    from repro.models.gnn import common as jcommon

    rng = np.random.default_rng(4)
    n, e = 50, 600
    seg = rng.integers(0, n - 5, e).astype(np.int32)
    seg[rng.random(e) < 1 / 3] = 17
    x = rng.normal(size=(e, 6)).astype(np.float32)
    jx, jseg = jnp.asarray(x), jnp.asarray(seg)
    tx, tseg = torch.from_numpy(x), torch.from_numpy(seg)
    plan = ops.segment_plan(tseg, n)
    for jfn, fn in ((jcommon.seg_mean, common.seg_mean), (jcommon.seg_max, common.seg_max),
                    (jcommon.seg_min, common.seg_min), (jcommon.seg_std, common.seg_std),
                    (jcommon.seg_softmax, common.seg_softmax)):
        want = np.asarray(jfn(jx, jseg, n))
        got = fn(tx, tseg, n, plan=plan)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(common.degrees(tseg, n, plan).numpy(),
                                  np.asarray(jcommon.degrees(jseg, n)))


def test_layer_norm_uses_the_biased_variance():
    from repro.models.gnn import common as jcommon

    x = np.random.default_rng(5).normal(size=(7, 5)).astype(np.float32) * 3
    np.testing.assert_allclose(common.layer_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jcommon.layer_norm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("profile", ["opencyc_like", "merge_like"])
def test_kg_dedup_matches_the_reference_example(profile):
    """The port's graph of a KG and its deduplication, through the port's
    own rho (``TorchEngine`` on the CPU), equal the reference example's
    procedure (``examples/kg_dedup_gnn.py``): the reference's rho, its
    Pallas rewrite in interpret mode, then ``np.unique`` over the edges."""
    facts, program, dic = generate(**PROFILES[profile])
    ref_facts, ref_program, ref_dic = ref_generate(**REF_PROFILES[profile])
    np.testing.assert_array_equal(facts, ref_facts)
    ref_rep = np.asarray(materialise(ref_facts, ref_program, ref_dic.n_resources,
                                     mode="REW").rep)
    _, rep, _ = TorchEngine(dic.n_resources, device="cpu").materialise(facts, program)
    np.testing.assert_array_equal(rep, ref_rep)

    graph = build_graph_from_kg(facts, dic.n_resources, 16, np.random.default_rng(0))
    ei = graph["edge_index"]
    assert ei.dtype == np.int32 and ei.shape[1] == int((facts[:, 1] != 1).sum())
    spo = np.stack([ei[0], np.zeros_like(ei[0]), ei[1]], axis=1)
    rewritten = np.asarray(jops.rewrite_triples(spo, ref_rep, interpret=True)[0])
    want = np.unique(rewritten[:, [0, 2]], axis=0)

    dedup = dedup_graph(graph, rep, "cpu")
    got = dedup["edge_index"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().T, want)
    assert dedup["edge_attr"].shape == (want.shape[0], 1)
    assert torch.equal(dedup["x"], torch.from_numpy(graph["x"]))
    assert want.shape[0] < ei.shape[1]  # the merges removed edges
