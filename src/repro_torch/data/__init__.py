"""Synthetic datasets of the port (copies of the reference generators)."""
