"""End to end: materialise a KG and answer SPARQL over it.

The paper-kind equivalent of "train a model end-to-end": generate a
clique-injected KG (default: the OpenCyc-like equality-dense profile), run
the full REW materialisation on the device (:class:`TorchEngine`),
validate Theorem 1 against the AX oracle on the host, then answer SPARQL
queries on the succinct store with bag-correct multiplicities.
``--spmd N`` runs the sharded engine over N ranks instead, one spawned
process a rank (:func:`repro_torch.launch.mesh.spawn`): gloo on the CPU;
on the card NCCL where there is a card a rank, else gloo with every rank
on card 0.

Run:  PYTHONPATH=src python -m repro_torch.examples.materialise_kg [--profile claros_like]
      PYTHONPATH=src python -m repro_torch.examples.materialise_kg --spmd 4
"""

import argparse
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.engine import TorchEngine
from repro_torch.core.materialise import check_theorem1, materialise
from repro_torch.data.generator import PROFILES, generate
from repro_torch.sparql import Query, evaluate


def _spmd_rank(rank: int, world: int, profile: str, device: str) -> None:
    """One rank of ``--spmd``: its shard of the engine; rank 0 prints."""
    from repro_torch.launch.mesh import make_engine_mesh

    if device != "cpu":
        device = f"cuda:{rank}" if torch.distributed.get_backend() == "nccl" else "cuda:0"
        torch.cuda.set_device(torch.device(device))
    facts, program, dic = generate(**PROFILES[profile])
    eng = TorchEngine(dic.n_resources, capacity=(1 << 17) // world,
                      bind_cap=1 << 14, out_cap=1 << 14, rewrite_cap=1 << 14,
                      device=device, mesh=make_engine_mesh())
    t0 = time.time()
    spo, _rep, stats = eng.materialise(facts, program)
    if rank == 0:
        print(f"SPMD({world} shards): {spo.shape[0]} triples, "
              f"{stats.derivations} derivations, {time.time()-t0:.2f}s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="opencyc_like", choices=sorted(PROFILES))
    ap.add_argument("--spmd", type=int, default=0,
                    help="run the sharded engine over N ranks instead")
    ap.add_argument("--skip-ax", action="store_true")
    ap.add_argument("--device", default="cuda", help="where REW runs (cuda or cpu)")
    args = ap.parse_args(argv)

    facts, program, dic = generate(**PROFILES[args.profile])
    print(f"[{args.profile}] {facts.shape[0]} facts, {len(program)} rules, "
          f"{dic.n_resources} resources")

    if args.spmd:
        from repro_torch.launch.mesh import spawn

        backend = "gloo"
        if args.device != "cpu" and torch.cuda.device_count() >= args.spmd:
            backend = "nccl"
        with tempfile.TemporaryDirectory() as tmp:
            spawn(_spmd_rank, args.spmd, (args.profile, args.device), backend=backend,
                  store_path=os.path.join(tmp, "store"))
        return

    t0 = time.time()
    triples, rep, stats = TorchEngine(dic.n_resources, device=args.device).materialise(
        facts, program)
    rew = SimpleNamespace(triples=lambda: triples, rep=rep, stats=stats)
    t_rew = time.time() - t0
    print(f"REW: {rew.stats.triples_unmarked} triples, "
          f"{rew.stats.derivations} derivations, "
          f"{rew.stats.merged_resources} merged, {t_rew:.2f}s")

    if not args.skip_ax:
        t0 = time.time()
        ax = materialise(facts, program, dic.n_resources, mode="AX")
        t_ax = time.time() - t0
        print(f"AX : {ax.stats.triples_unmarked} triples, "
              f"{ax.stats.derivations} derivations, {t_ax:.2f}s "
              f"-> REW is {t_ax / max(t_rew, 1e-9):.1f}x faster")
        check_theorem1(rew, ax)
        print("Theorem 1 validated (T^rho == AX materialisation)")

    q = Query.parse("SELECT ?x WHERE { (?x, :spoke, ?y) }", dic)
    t0 = time.time()
    ans = evaluate(q, rew.triples(), np.asarray(rew.rep), dic)
    print(f"\nSPARQL over T (bag semantics): {sum(ans.values())} answers, "
          f"{len(ans)} distinct, {1e3*(time.time()-t0):.1f}ms")
    top = ans.most_common(3)
    for row, count in top:
        print(f"   {row} x{count}")


if __name__ == "__main__":
    main()
