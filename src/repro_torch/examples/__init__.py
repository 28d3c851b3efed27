"""Runnable examples of the port, one module each, run as
``python -m repro_torch.examples.<name> [--device cpu]``; each mirrors the
reference's ``examples/<name>.py`` (its arguments, defaults and printed
lines) and runs on the card unless ``--device cpu`` is given:

  * ``quickstart``     — the paper's running example: AX against REW
    (REW by :class:`~repro_torch.core.engine.TorchEngine`), Theorem 1;
  * ``materialise_kg`` — a generated KG materialised, Theorem 1 against
    the AX oracle, SPARQL over the store (``--spmd N``: the sharded engine
    over N ranks);
  * ``serve_sparql``   — a :class:`~repro_torch.serve.TripleStore` under
    interleaved updates and queries;
  * ``serve_lm``       — continuous batching with
    :class:`~repro_torch.serve.ServeEngine`;
  * ``train_lm``       — the fault-tolerant :class:`~repro_torch.train.Trainer`;
  * ``kg_dedup_gnn``   — rho from REW rewrites a GNN's edges (the
    ``rewrite_triples`` kernel), GatedGCN trained on both graphs.
"""
