"""Template models of the port: the dense decoder-only LM and the FM."""
