"""Serve SPARQL against a live, mutating triple store.

Demonstrates the epoch-snapshot consistency contract of
:mod:`repro_torch.serve.triple_store`: a standing store admits interleaved
add/delete batches and SPARQL queries; every answer is computed against
the fixpoint of a *completed* maintenance epoch and expanded through that
epoch's rho, even when the query lands between an overdelete wave and its
rederivation.  The store's engine runs on the device.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_sparql [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.data.generator import generate, sample_update_stream
from repro_torch.serve.triple_store import TripleStore
from repro_torch.sparql.algebra import Query


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where the store runs (cuda or cpu)")
    args = ap.parse_args(argv)

    facts, program, dic = generate(
        n_groups=4, group_size=4, n_spokes_per=3, n_plain=60,
        hierarchy_depth=2, seed=0,
    )
    print(f"explicit facts: {facts.shape[0]}")
    store = TripleStore(facts, program, dic, device=args.device)
    print(
        f"epoch {store.epoch}: serving {store.snapshot.triples.shape[0]} "
        "normal-form triples"
    )

    # Q: who points a :spoke at group 0's entity?  ?y is projected out, so
    # each answer is multiplied by the sameAs-clique size bound to ?y.
    spoke = dic.id_of(":spoke")
    q = Query([(-1, spoke, -2)], [], [-1], False)
    t = store.query_now(q)
    print(f"\n[epoch {t.epoch}] spoke subjects (bag): {sorted(t.answer.items())[:4]} ...")

    # delete one :idProp edge -> the derived clique splits; admit a query
    # while the maintenance epoch is mid-overdelete
    idp = dic.id_of(":idProp")
    edge = facts[np.flatnonzero(facts[:, 1] == idp)[:1]]
    ut = store.submit_update("delete", edge)
    while store.inflight_phase != "overdeleted":
        store.step()
    mid = store.submit_query(q)
    store.step()  # answers the query (previous epoch), advances maintenance
    print(
        f"\nquery admitted mid-overdelete: served at epoch {mid.epoch} "
        f"(update still {ut.status}); bag total {sum(mid.answer.values())}"
    )
    store.drain()
    after = store.query_now(q)
    print(
        f"after the barrier: epoch {after.epoch}, bag total "
        f"{sum(after.answer.values())} (clique split shrank the multiplicities)"
    )

    # a mixed query+update trace through the scheduler
    trace = sample_update_stream(
        facts, dic, n_events=8, batch=12, p_query=0.5, seed=1
    )
    tickets = []
    for op, payload in trace:
        if op == "query":
            tickets.append(store.submit_query(payload))
        else:
            store.submit_update(op, payload)
        store.step()
    store.drain()
    print("\nmixed trace: queries answered at epochs "
          f"{[t.epoch for t in tickets]} (final epoch {store.epoch})")


if __name__ == "__main__":
    main()
