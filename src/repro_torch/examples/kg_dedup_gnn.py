"""owl:sameAs rewriting as entity resolution for GNN training.

The paper's technique meeting the assigned GNN architectures: a KG whose
entities carry duplicate registrations is materialised with REW
(:class:`TorchEngine`); the representative map rho then rewrites the
GNN's edge_index (``ops.rewrite_triples``, the hand-written kernel on the
card) and merged nodes collapse: fewer nodes and deduplicated edges before
message passing.  The same GatedGCN trains on both graphs (the port's
``loss_fn``, its gradients and AdamW); the deduped one is smaller.

Run:  PYTHONPATH=src python -m repro_torch.examples.kg_dedup_gnn [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.compat import pytree
from repro_torch.configs import get_arch
from repro_torch.core.engine import TorchEngine
from repro_torch.core.terms import SAME_AS
from repro_torch.data.generator import generate
from repro_torch.kernels import ops
from repro_torch.models.gnn import gatedgcn
from repro_torch.optim import adamw_init, adamw_update


def build_graph_from_kg(triples, n_nodes, d_feat, rng):
    """Edge list = non-sameAs payload triples; random features per node."""
    payload = triples[triples[:, 1] != SAME_AS]
    src, dst = payload[:, 0], payload[:, 2]
    x = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = (np.arange(n_nodes) % 4).astype(np.int32)
    return {
        "x": x,
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": np.ones((src.shape[0], 1), np.float32),
        "labels": labels,
        "train_mask": np.ones(n_nodes, np.float32),
    }


def train(batch, device, steps=40):
    cfg = get_arch("gatedgcn").reduced
    cfg = dataclasses.replace(cfg, d_in=batch["x"].shape[1])
    params = gatedgcn.init_params(torch.Generator().manual_seed(0), cfg, device=device)
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    flat, spec = pytree.tree_flatten(params)

    t0 = time.time()
    for _ in range(steps):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = gatedgcn.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params, opt, _ = adamw_update(pytree.tree_unflatten(flat, spec),
                                          pytree.tree_unflatten(list(grads), spec), opt,
                                          lr=3e-3)
        flat = pytree.tree_leaves(params)
    return loss.item(), time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    facts, program, dic = generate(
        n_groups=150, group_size=5, n_spokes_per=4, n_plain=4000, hierarchy_depth=0
    )
    _, rep, _ = TorchEngine(dic.n_resources, device=args.device).materialise(facts, program)

    # RAW graph: duplicates present (edges point at different copies)
    raw = build_graph_from_kg(facts, dic.n_resources, d_feat=16, rng=rng)

    # DEDUP graph: rewrite edge endpoints through rho, drop duplicate edges
    spo = np.stack(
        [raw["edge_index"][0], np.zeros_like(raw["edge_index"][0]), raw["edge_index"][1]],
        axis=1,
    )
    rewritten, _changed = ops.rewrite_triples(torch.from_numpy(spo).to(args.device),
                                              torch.from_numpy(rep).to(args.device))
    rewritten = rewritten.cpu().numpy()
    edges = np.unique(rewritten[:, [0, 2]], axis=0)
    dedup = dict(raw)
    dedup["edge_index"] = edges.T.astype(np.int32).copy()
    dedup["edge_attr"] = np.ones((edges.shape[0], 1), np.float32)

    n_merged = int((rep != np.arange(rep.shape[0])).sum())
    print(f"KG: {facts.shape[0]} facts, {n_merged} entities merged by rho")
    print(f"raw graph:   {raw['edge_index'].shape[1]} edges")
    print(f"dedup graph: {dedup['edge_index'].shape[1]} edges "
          f"({raw['edge_index'].shape[1] - dedup['edge_index'].shape[1]} removed)")

    loss_raw, t_raw = train(raw, args.device)
    loss_dd, t_dd = train(dedup, args.device)
    print(f"gatedgcn 40 steps | raw:   loss={loss_raw:.3f}  {t_raw:.1f}s")
    print(f"gatedgcn 40 steps | dedup: loss={loss_dd:.3f}  {t_dd:.1f}s")


if __name__ == "__main__":
    main()
