"""Fanout neighbour sampler for ``minibatch_lg`` (GraphSAGE-style).

The port of ``repro.data.sampler``, numpy, with the same draws from the
same generator.  CSR-backed uniform sampling with replacement; it makes a
fixed-size padded subgraph: the seeds, ``fanout[0]`` neighbours of each and
``fanout[1]`` second-hop neighbours of those, renumbered locally.

The isolated-node clamp is the reference's, kept as it is: a node without
an in-edge gets ``idx = indptr[node]``, which reads the *next* node's
first in-neighbour, and a node after the last in-edge indexes one past the
end of ``nbr`` (an ``IndexError``).  Callers that want neither give every
node an in-edge (``chip_smoke.py`` samples an undirected graph of the nodes
that have an edge).
"""

from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, n_nodes: int, edge_index: np.ndarray):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def _sample_neighbors(self, rng, nodes: np.ndarray, k: int):
        lo = self.indptr[nodes]
        hi = self.indptr[nodes + 1]
        deg = np.maximum(hi - lo, 1)
        pick = rng.integers(0, deg[:, None], (nodes.shape[0], k))
        idx = np.minimum(lo[:, None] + pick, np.maximum(hi[:, None] - 1, lo[:, None]))
        return self.nbr[idx]  # (n, k); the isolated-node clamp above

    def sample(self, rng: np.random.Generator, seeds: np.ndarray, fanout=(15, 10)):
        """Returns (sub_nodes, sub_edge_index, seed_positions); fixed sizes
        n_sub = s*(1 + f0 + f0*f1), e_sub = s*f0 + s*f0*f1."""
        s = seeds.shape[0]
        h1 = self._sample_neighbors(rng, seeds, fanout[0])  # (s, f0)
        h2 = self._sample_neighbors(rng, h1.reshape(-1), fanout[1])  # (s*f0, f1)
        nodes = np.concatenate([seeds, h1.reshape(-1), h2.reshape(-1)])
        uniq, inv = np.unique(nodes, return_inverse=True)
        n_sub = s * (1 + fanout[0] + fanout[0] * fanout[1])
        # pad the unique node set to the static cap
        pad = n_sub - uniq.shape[0]
        sub_nodes = np.pad(uniq, (0, max(0, pad)), mode="edge")[:n_sub]
        seed_pos = inv[:s].astype(np.int32)
        # edges: h1 -> seeds, h2 -> h1
        src1 = inv[s : s + s * fanout[0]]
        dst1 = np.repeat(inv[:s], fanout[0])
        src2 = inv[s + s * fanout[0] :]
        dst2 = np.repeat(src1, fanout[1])
        src = np.concatenate([src1, src2]).astype(np.int32)
        dst = np.concatenate([dst1, dst2]).astype(np.int32)
        return sub_nodes.astype(np.int32), np.stack([src, dst]), seed_pos
