"""Serving of the port: the LM server with continuous batching.  The
triple store's serving tier is a later slice (ROADMAP Queue 1 item 5)."""

from .engine import Request, ServeEngine, decode_step_multipos

__all__ = ["Request", "ServeEngine", "decode_step_multipos"]
