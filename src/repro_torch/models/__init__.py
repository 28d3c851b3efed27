"""Template models of the port: the dense decoder-only LM, the FM and the
GNNs (GatedGCN, PNA)."""
