"""PyTorch/CUDA port of the sameAs-rewriting materialisation engine.

``repro_torch`` sits beside the JAX package ``repro``, which stays the
reference.  It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Ported so far, with hand-written CUDA kernels for Hopper
(:mod:`repro_torch.kernels`): the REW base materialisation
(:class:`repro_torch.core.engine.TorchEngine`, whose default round loop is
the fused one of :mod:`repro_torch.core.fused`, a CUDA graph a round on the
card) and its incremental add and delete
(:mod:`repro_torch.core.incremental_spmd`, one device; the numpy host
subsystem :mod:`repro_torch.core.incremental`) with the paper's oracle and
AX baseline
(:mod:`repro_torch.core.materialise`), LM serving
(:mod:`repro_torch.serve`, :mod:`repro_torch.models.transformer`), FM
serving (:mod:`repro_torch.models.recsys`) and GNN inference on a
sameAs-deduplicated graph (:mod:`repro_torch.models.gnn`,
:mod:`repro_torch.data.graphs`).
"""

from repro_torch.core.engine import CapacityError, Contradiction, TorchEngine

__all__ = ["CapacityError", "Contradiction", "TorchEngine"]
