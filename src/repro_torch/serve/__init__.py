"""Serving of the port: the LM server with continuous batching, and the
triple store's serving tier (SPARQL over epoch snapshots of a store under
maintenance)."""

from .engine import Request, ServeEngine, decode_step_multipos
from .triple_store import QueryTicket, TripleStore, UpdateTicket

__all__ = ["Request", "ServeEngine", "decode_step_multipos", "TripleStore",
           "UpdateTicket", "QueryTicket"]
