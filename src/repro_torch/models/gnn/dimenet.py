"""DimeNet — directional message passing (Gasteiger et al., arXiv:2003.03123).

Messages live on *directed edges*; the interaction block aggregates over
triplets (k->j->i) with a radial Bessel basis on distances and an angular
basis on the k-j-i angle, combined through an ``n_bilinear`` tensor layer.

The port of ``repro.models.gnn.dimenet``, with the reference's
compact-faithful deviations (cos(l * angle) harmonics times a radial
Bessel basis in place of spherical Bessel functions and harmonics;
DimeNet++-style output blocks).  Every sum over triplets, edges and nodes
goes through the ``segment_sum`` kernel, and so does the backward of every
gather by an index array: ``pos[dst]``, ``pos[src]``, ``rel[t_in]``,
``rel[t_out]``, ``d[t_in]``, the species embedding ``[z]``, ``hz[src]``,
``hz[dst]`` and each block's ``[t_in]``.  The forward builds one segment
plan of each index array.  The bilinear layer is ``torch.einsum`` (a
product the reference leaves to XLA).

Triplet indices (t_in: edge k->j, t_out: edge j->i) come with the batch
(:func:`repro_torch.data.pipeline.build_triplets`).

With a ``mesh`` the edges and the triplets are this rank's blocks along
the data axes (:mod:`.common`'s edge parallelism).  A triplet reads edges
that other ranks hold: the edge rows it reads (``rel`` and each block's
``m_rbf @ w_kj``) are all-gathered over the data axes (their gradients
reduce-scattered back), and the triplet sum into the edges is
reduce-scattered to this rank's edges.  ``species_emb`` and ``out_atom``
act on node rows, the other weights on edge or triplet rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops

from repro_torch.core import collectives as coll

from .common import edge_shard, edge_side, gather, init_mlp, mlp, seg_sum


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16
    envelope_p: int = 6


def radial_bessel(d, n_radial, cutoff, p=6):
    """Bessel RBF with smooth polynomial envelope (DimeNet eq. 7-8)."""
    d = d / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    # envelope u(d): 1 + a d^p + b d^(p+1) + c d^(p+2)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    env = 1.0 + a * d**p + b * d ** (p + 1) + c * d ** (p + 2)
    env = torch.where(d < 1.0, env, 0.0)
    return (env[:, None] * math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d[:, None])
            / torch.clamp(d[:, None], min=1e-6))


def angular_basis(angle, d, n_spherical, n_radial, cutoff):
    """(T, n_spherical * n_radial): cos(l*angle) x radial Bessel of d_kj."""
    rbf = radial_bessel(d, n_radial, cutoff)  # (T, n_radial)
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(l[None, :] * angle[:, None])  # (T, n_spherical)
    return (ang[:, :, None] * rbf[:, None, :]).reshape(angle.shape[0], -1)


def init_params(gen: torch.Generator, cfg: DimeNetConfig,
                device: str | torch.device = "cuda") -> dict:
    """The reference's tree: the species embedding normal * 0.1, the
    bilinear tensor normal * d_hidden^-0.5, other weights normal *
    fan_in^-0.5, zero biases; f32 on ``device``, drawn from ``gen``."""
    device = resolve(device, "init_params")
    h, nb = cfg.d_hidden, cfg.n_bilinear
    nsr = cfg.n_spherical * cfg.n_radial

    def m(dims):
        return init_mlp(gen, dims, device=device)

    def randn(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(device)

    return {
        "species_emb": randn((cfg.n_species, h), 0.1),
        "edge_mlp": m([2 * h + cfg.n_radial, h, h]),
        "blocks": [
            {
                "w_rbf": m([cfg.n_radial, h])[0][0],
                "w_sbf": m([nsr, nb])[0][0],
                "w_kj": m([h, h])[0][0],
                "bilinear": randn((h, nb, h), h**-0.5),
                "mlp_out": m([h, h, h]),
                "out_atom": m([h, h, 1]),
            }
            for _ in range(cfg.n_blocks)
        ],
    }


def forward(params, cfg: DimeNetConfig, batch: dict, mesh=None):
    """batch: z (N,) species, pos (N,3), edge_index (2,E) j->i, triplets
    (2,T) = (edge id k->j, edge id j->i), graph_ids, n_graphs; ids int32.
    Returns the per-graph energy (G,).  With ``mesh``, the edges and
    triplets are this rank's (the triplets' edge ids global)."""
    ax = edge_shard(mesh)
    z, pos = batch["z"], batch["pos"].float()
    src, dst = batch["edge_index"][0], batch["edge_index"][1]
    t_in, t_out = batch["triplets"][0], batch["triplets"][1]
    gid, n_graphs = batch["graph_ids"], int(batch["n_graphs"])
    n, e = z.shape[0], src.shape[0] * (1 if ax is None else ax.size)
    plan, src_plan = ops.segment_plan(dst, n), ops.segment_plan(src, n)
    in_plan, out_plan = ops.segment_plan(t_in, e), ops.segment_plan(t_out, e)
    z_plan = ops.segment_plan(z, cfg.n_species)
    gid_plan = ops.segment_plan(gid, n_graphs)

    def every_edge(rows):  # the edge rows of every rank, for the triplets
        return rows if ax is None else coll.all_gather_dim(rows, ax.mesh, ax.axes, 0)

    rel = gather(pos, dst, plan, ax) - gather(pos, src, src_plan, ax)
    d = torch.sqrt(torch.clamp((rel * rel).sum(-1), min=1e-12))
    rbf = radial_bessel(d, cfg.n_radial, cfg.cutoff, cfg.envelope_p)
    rel_all = every_edge(rel)
    d_all = d if ax is None else torch.sqrt(torch.clamp((rel_all * rel_all).sum(-1),
                                                        min=1e-12))

    # triplet angle between edge (k->j) and (j->i): vectors meet at j
    v_kj = -gather(rel_all, t_in, in_plan)
    v_ji = gather(rel_all, t_out, out_plan)
    cosang = (v_kj * v_ji).sum(-1) / torch.clamp(
        torch.linalg.norm(v_kj, dim=-1) * torch.linalg.norm(v_ji, dim=-1), min=1e-9
    )
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sbf = angular_basis(angle, gather(d_all, t_in, in_plan), cfg.n_spherical,
                        cfg.n_radial, cfg.cutoff)

    hz = gather(params["species_emb"], z, z_plan)
    m = mlp(edge_side(params["edge_mlp"], ax),
            torch.cat([gather(hz, src, src_plan, ax), gather(hz, dst, plan, ax), rbf],
                      -1))  # (E, H)

    energy = torch.zeros((n_graphs, 1), dtype=torch.float32, device=pos.device)
    for blk in params["blocks"]:
        eb = edge_side({k: blk[k] for k in ("w_rbf", "w_sbf", "w_kj", "bilinear",
                                            "mlp_out")}, ax)
        m_rbf = m * (rbf @ eb["w_rbf"])  # (E, H)
        m_kj = gather(every_edge(m_rbf @ eb["w_kj"]), t_in, in_plan)  # (T, H)
        sb = sbf @ eb["w_sbf"]  # (T, nb)
        inter = torch.einsum("th,tb,hbo->to", m_kj, sb, eb["bilinear"])  # (T, H)
        agg = seg_sum(inter, t_out, e, out_plan)  # (E, H)
        if ax is not None:
            agg = coll.reduce_scatter_dim(agg, ax.mesh, ax.axes, 0)
        m = m + mlp(eb["mlp_out"], agg)
        atom = seg_sum(m, dst, n, plan, ax)  # (N, H)
        contrib = mlp(blk["out_atom"], atom)  # (N, 1)
        energy = energy + seg_sum(contrib.float(), gid, n_graphs, gid_plan)
    return energy[:, 0]


def loss_fn(params, cfg: DimeNetConfig, batch: dict, mesh=None):
    """Mean squared error of the energy against ``batch["y"]``."""
    err = forward(params, cfg, batch, mesh) - batch["y"].float()
    return (err * err).mean()
