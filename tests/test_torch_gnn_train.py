"""GNN training in the port against the reference on the CPU: the loss and
every gradient leaf of EGNN, DimeNet, GatedGCN and PNA, the data pipeline
and the neighbour sampler, and the autograd of the segment sum and the row
gather.

The models run with the reference's weights carried over by
``params_from_numpy``, at ``REDUCED`` and at full width with 2 layers or
blocks, on ``molecule_batch`` (4 graphs of 30 nodes and 64 edges) or on a
``random_graph``.  The reference differentiates with
``jax.value_and_grad`` (under ``jax.jit``), the port with
``torch.autograd.grad``.  Both are f32 and sum in other orders, so the
loss agrees within ``LOSS_RTOL`` and each gradient leaf within
``GRAD_TOL`` of its largest reference value.  Measured on these inputs:
loss at most 6.7e-7 relative (DimeNet at full width), gradients at most
3.2e-4 of a leaf's largest value (PNA at full width: its standard
deviation cancels, as in ``test_torch_gnn.py``), 3.6e-6 for every other
model.  Where a reference gradient is not finite, the port's must not be
either, at the same leaf entries (DimeNet's ``arccos`` of a clipped
cosine); none was on these inputs.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data.sampler import NeighborSampler as JNeighborSampler  # noqa: E402
from repro.models.gnn import (  # noqa: E402
    dimenet as jdimenet, egnn as jegnn, gatedgcn as jgatedgcn, pna as jpna,
)
from repro_torch.ckpt.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.graphs import graph_to  # noqa: E402
from repro_torch.data.sampler import NeighborSampler  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.gnn import dimenet, egnn, gatedgcn, pna  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
MODELS = {"egnn": (jegnn, egnn), "dimenet": (jdimenet, dimenet),
          "gatedgcn": (jgatedgcn, gatedgcn), "pna": (jpna, pna)}
DEPTH = {"egnn": "n_layers", "dimenet": "n_blocks", "gatedgcn": "n_layers",
         "pna": "n_layers"}


def _config(name, size):
    spec = ref_arch(name)
    if size == "reduced":
        return spec.reduced
    return dataclasses.replace(spec.config, **{DEPTH[name]: 2})


def _batch(name, jcfg):
    rng = np.random.default_rng(0)
    if name in ("egnn", "dimenet"):
        return pipeline.molecule_batch(rng, 4, 30, 64)
    n, e = (40, 160) if jcfg.n_layers == 3 else (200, 800)
    return pipeline.random_graph(rng, n, e, jcfg.d_in, jcfg.n_classes)


def port_grads(mod, params, cfg, batch):
    """The port's loss and gradient tree (zeros for unused leaves, as
    ``jax.grad`` gives them)."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = mod.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def ref_grads(jmod, jparams, jcfg, batch):
    """The reference's loss and gradients, jitted, with the batch's Python
    ints held static."""
    static = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    fn = jax.jit(lambda p, b: jax.value_and_grad(jmod.loss_fn)(p, jcfg, {**b, **static}))
    return fn(jparams, arrays)


def assert_grads_match(grads, jgrads):
    ours = _flatten(grads)
    theirs = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [k for k, _ in ours] == [jax.tree_util.keystr(p) for p, _ in theirs]
    for (key, g), (_, jg) in zip(ours, theirs):
        g, jg = g.numpy(), np.asarray(jg)
        finite = np.isfinite(jg)
        np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=key)
        if finite.any():
            scale = np.abs(jg[finite]).max()
            np.testing.assert_allclose(g[finite], jg[finite], rtol=0,
                                       atol=GRAD_TOL * scale + 1e-30, err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("size", ["reduced", "full_width"])
def test_loss_and_grads_match_reference(name, size):
    jmod, mod = MODELS[name]
    jcfg = _config(name, size)
    cfg = type(get_arch(name).config)(**dataclasses.asdict(jcfg))
    batch = _batch(name, jcfg)
    jparams = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jloss, jgrads = ref_grads(jmod, jparams, jcfg, batch)
    loss, grads = port_grads(mod, params, cfg, graph_to(batch, "cpu"))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert_grads_match(grads, jgrads)


@pytest.mark.parametrize("name", ["egnn", "dimenet"])
def test_forward_matches_reference(name):
    """EGNN's prediction and final positions, DimeNet's energies, at
    ``REDUCED`` (within 1e-5 of the largest value)."""
    jmod, mod = MODELS[name]
    jcfg = _config(name, "reduced")
    cfg = type(get_arch(name).config)(**dataclasses.asdict(jcfg))
    batch = _batch(name, jcfg)
    jparams = jmod.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    static = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    want = jax.jit(lambda p, b: jmod.forward(p, jcfg, {**b, **static}))(jparams, arrays)
    got = mod.forward(params, cfg, graph_to(batch, "cpu"))
    for w, g in zip(jax.tree.leaves(want), pytree.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_egnn_equivariance():
    """Rotating and translating the positions rotates the coordinate
    output and leaves the prediction unchanged (the reference's test,
    ``test_arch_smoke.py``, with its tolerance 2e-3)."""
    rng = np.random.default_rng(0)
    cfg = get_arch("egnn").reduced
    b = pipeline.molecule_batch(rng, n_graphs=2, nodes_per=5, edges_per=12)
    b["x"] = rng.normal(size=(10, cfg.d_in)).astype(np.float32)
    batch = graph_to(b, "cpu")
    params = egnn.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    pred1, pos1 = egnn.forward(params, cfg, batch)
    q = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    t = torch.tensor([1.0, -2.0, 0.5])
    pred2, pos2 = egnn.forward(params, cfg, dict(batch, pos=batch["pos"] @ q + t))
    torch.testing.assert_close(pred1, pred2, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(pos1 @ q + t, pos2, rtol=2e-3, atol=2e-3)


def test_forward_builds_one_plan_per_index_array(monkeypatch):
    """DimeNet plans dst, src, t_in, t_out, z and graph_ids once each, and
    every gather and segment sum of the forward (and so of its backward)
    goes through them."""
    cfg = get_arch("dimenet").reduced
    batch = graph_to(pipeline.molecule_batch(np.random.default_rng(2), 2, 8, 12), "cpu")
    plans, gathers, sums = [], [], []
    real_plan, real_gather, real_sum = ops.segment_plan, ops.gather_rows, ops.segment_sum

    def plan_spy(seg, n):
        plans.append(real_plan(seg, n))
        return plans[-1]

    def gather_spy(x, idx, plan=None):
        gathers.append(plan)
        return real_gather(x, idx, plan)

    def sum_spy(x, seg, n, plan=None):
        sums.append(plan)
        return real_sum(x, seg, n, plan=plan)

    monkeypatch.setattr(ops, "segment_plan", plan_spy)
    monkeypatch.setattr(ops, "gather_rows", gather_spy)
    monkeypatch.setattr(ops, "segment_sum", sum_spy)
    params = dimenet.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    dimenet.forward(params, cfg, batch)
    assert len(plans) == 6
    assert len(gathers) == 8 + cfg.n_blocks and len(sums) == 3 * cfg.n_blocks
    assert all(any(p is q for q in plans) for p in gathers + sums)


# ---------------------------------------------------------------------------
# the data pipeline and the sampler
# ---------------------------------------------------------------------------

def _same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pipeline_is_the_reference():
    for step in (0, 7):
        _same_arrays(pipeline.lm_batch(step, 3, 16, 1000),
                     jpipeline.lm_batch(step, 3, 16, 1000))
        _same_arrays(pipeline.recsys_batch(step, 5, 39, 100),
                     jpipeline.recsys_batch(step, 5, 39, 100))
    for args in ((4, 30, 64), (3, 6, 14, 5)):
        _same_arrays(pipeline.molecule_batch(np.random.default_rng(1), *args),
                     jpipeline.molecule_batch(np.random.default_rng(1), *args))
    _same_arrays(pipeline.random_graph(np.random.default_rng(2), 30, 90, 8, 4),
                 jpipeline.random_graph(np.random.default_rng(2), 30, 90, 8, 4))
    assert pipeline.random_graph is __import__(
        "repro_torch.data.graphs", fromlist=["random_graph"]).random_graph


@pytest.mark.parametrize("cap", [1, 7, 40, 1000])
def test_build_triplets_is_the_reference(cap):
    """The cap (its first-hit break) and the edge padding; an edge list with
    no triplet pads (0, 0)."""
    edge_index = jpipeline.molecule_batch(np.random.default_rng(3), 2, 6, 10)["edge_index"]
    np.testing.assert_array_equal(pipeline.build_triplets(edge_index, cap),
                                  jpipeline.build_triplets(edge_index, cap))
    lone = np.array([[0], [1]], np.int32)
    np.testing.assert_array_equal(pipeline.build_triplets(lone, 3),
                                  jpipeline.build_triplets(lone, 3))


def test_sampler_is_the_reference():
    """``minibatch_lg``'s geometry cut down: 32 seeds, fanout (5, 3), from
    the same generator; the same subgraph, array for array."""
    rng = np.random.default_rng(4)
    n = 500
    edge_index = np.stack([rng.integers(0, n, 3000), rng.integers(0, n, 3000)]).astype(np.int32)
    seeds = rng.choice(n, 32, replace=False).astype(np.int32)
    got = NeighborSampler(n, edge_index).sample(np.random.default_rng(5), seeds, (5, 3))
    want = JNeighborSampler(n, edge_index).sample(np.random.default_rng(5), seeds, (5, 3))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (2, 32 * 5 + 32 * 5 * 3)


def test_sampler_isolated_node_clamp_is_the_reference():
    """The reference's clamp, kept: node 1 has no in-edge and samples node
    2's first in-neighbour (9); node 4, after the last in-edge, indexes one
    past ``nbr`` and raises in both packages."""
    edge_index = np.array([[5, 9, 7], [0, 2, 3]], np.int32)  # in-edges of 0, 2, 3
    ours, theirs = NeighborSampler(5, edge_index), JNeighborSampler(5, edge_index)
    for nodes in (np.array([1]), np.array([0, 1, 2, 3])):
        got = ours._sample_neighbors(np.random.default_rng(0), nodes, 4)
        want = theirs._sample_neighbors(np.random.default_rng(0), nodes, 4)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [9, 9, 9, 9])
    for sampler in (ours, theirs):
        with pytest.raises(IndexError):
            sampler._sample_neighbors(np.random.default_rng(0), np.array([4]), 2)


# ---------------------------------------------------------------------------
# the autograd of the segment sum and the row gather
# ---------------------------------------------------------------------------

def _plain_segment_sum(x, seg, n):
    """The plain ``index_add_`` version, differentiated by torch."""
    keep = (seg >= 0) & (seg < n)
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype)
    return out.index_add(0, seg[keep].to(torch.int64), x[keep])


@pytest.mark.parametrize("k", [1, 3, 70])
def test_segment_sum_and_gather_rows_autograd(k):
    """Values and gradients of ``ops.segment_sum`` (ids out of range
    included) and ``ops.gather_rows`` (a hub, unused rows, a 1-d table)
    against torch's autograd of the plain versions: equal in f32 up to
    the order of the sums (1e-6)."""
    rng = np.random.default_rng(k)
    n, e = 40, 300
    seg = torch.from_numpy(rng.integers(-3, n + 3, e).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(e, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (ops.segment_sum(x1, seg, n) * w).sum().backward()
    (_plain_segment_sum(x2, seg, n) * w).sum().backward()
    torch.testing.assert_close(x1.grad, x2.grad, rtol=0, atol=0)

    idx = torch.from_numpy(np.where(rng.random(e) < 0.3, 5,
                                    rng.integers(0, n - 4, e)).astype(np.int32))
    table = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(e, k)).astype(np.float32))
    for t, gt in ((table, g), (table[:, 0], g[:, 0])):
        t1, t2 = t.clone().requires_grad_(True), t.clone().requires_grad_(True)
        out = ops.gather_rows(t1, idx, ops.segment_plan(idx, n))
        torch.testing.assert_close(out, t2[idx.to(torch.int64)], rtol=0, atol=0)
        (out * gt).sum().backward()
        (t2[idx.to(torch.int64)] * gt).sum().backward()
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-6, atol=1e-6)
        assert t1.grad[n - 1].abs().sum() == 0  # an unused row


def test_segment_sum_backward_equals_ref_gather():
    """The backward of the sum is the row gather of the output gradient,
    zero for dropped rows, in bf16 too."""
    rng = np.random.default_rng(9)
    seg = torch.from_numpy(rng.integers(-2, 12, 50).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(50, 4, dtype=dtype, requires_grad=True)
        out = ops.segment_sum(x, seg, 10)
        torch.testing.assert_close(out, ref.segment_sum(x.detach(), seg, 10))
        go = torch.randn(10, 4, dtype=dtype)
        (gx,) = torch.autograd.grad(out, x, go)
        keep = ((seg >= 0) & (seg < 10))[:, None]
        want = torch.where(keep, go[seg.clamp(0, 9).to(torch.int64)], 0)
        assert gx.dtype == dtype and torch.equal(gx, want)
