"""The port's version-sensitive imports, in one place.

The reference's ``repro.compat`` holds three JAX shims: ``make_mesh``'s
axis types (jax >= 0.5), ``shard_map``'s move to the top level (jax 0.6)
and ``Compiled.cost_analysis()``'s list-or-dict return.  The port needs
none of them: its meshes are process groups (:mod:`repro_torch.launch.mesh`)
with no axis types, each rank runs its own block eagerly where the
reference maps a function over a mesh, and the dry run counts an eager
step (:mod:`repro_torch.launch.costs`) instead of reading a compiled
module's analysis.

What the port does lean on that is not a stable public surface of PyTorch
(2.11 on the card, 2.13 in the test container):

* ``pytree`` is ``torch.utils._pytree``, a private module that torch has
  no public name for; every module of the port takes it from here;
* :func:`fake_store` registers the ``fake`` process-group backend (a
  group that moves nothing: the dry run's world of 256 or 512 ranks in one
  process) and gives the store it is initialised with.  Both live in
  ``torch.testing._internal.distributed.fake_pg``, whose import registers
  the backend.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

__all__ = ["fake_store", "pytree"]


def fake_store():
    """A store for ``torch.distributed.init_process_group("fake", ...)``,
    with the ``fake`` backend registered."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()
