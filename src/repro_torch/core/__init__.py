"""Host-side IR, union-find and the REW engine of the port."""
