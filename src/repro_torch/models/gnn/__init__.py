"""GNNs of the port: GatedGCN and PNA, message passing through the
``segment_sum`` kernel."""
