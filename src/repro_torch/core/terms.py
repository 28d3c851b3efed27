"""Dictionary encoding of RDF terms.

Resources are interned to dense nonzero int32 IDs (the paper: "resources are
encoded using nonzero integer resource IDs in a way that allows IDs to be used
as array indexes").  Variables in rules are encoded as *negative* integers so a
rule atom is just an int32 triple.  ID 0 is reserved as the invalid sentinel.

IDs must stay below 2**21 so a triple packs into one int64 sort key
(21 bits per position); see :mod:`repro_torch.core.triples`.

A copy of ``repro.core.terms``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterable

# Reserved resource IDs (positions 1..N_RESERVED-1).
INVALID = 0
SAME_AS = 1          # owl:sameAs
DIFFERENT_FROM = 2   # owl:differentFrom
N_RESERVED = 3

# packing limit for int64 triple keys; the top IDs are reserved so the
# engine's KEY_MAX padding sentinel can never collide with a dictionary key.
# (Raw engine inputs may exceed MAX_ID up to 2^21-1: probes mask validity
# explicitly rather than leaning on a KEY_MAX-1 sentinel, which aliases the
# packed key of <2^21-1, 2^21-1, 2^21-2>.  The single triple whose IDs are
# ALL 2^21-1 packs to KEY_MAX itself and stays reserved — the engine never
# stores it.)
MAX_ID = (1 << 21) - 3

RESERVED_NAMES = {
    "owl:sameAs": SAME_AS,
    "owl:differentFrom": DIFFERENT_FROM,
}


class Dictionary:
    """Host-side bidirectional resource <-> ID mapping."""

    def __init__(self) -> None:
        self._to_id: dict[str, int] = dict(RESERVED_NAMES)
        self._to_name: list[str | None] = [None] * N_RESERVED
        self._to_name[SAME_AS] = "owl:sameAs"
        self._to_name[DIFFERENT_FROM] = "owl:differentFrom"

    def __len__(self) -> int:
        return len(self._to_name)

    @property
    def n_resources(self) -> int:
        return len(self._to_name)

    def intern(self, name: str) -> int:
        rid = self._to_id.get(name)
        if rid is None:
            rid = len(self._to_name)
            if rid > MAX_ID:
                raise OverflowError(
                    f"resource ID space exhausted ({rid} > {MAX_ID}); "
                    "widen the packing in triples.py"
                )
            self._to_id[name] = rid
            self._to_name.append(name)
        return rid

    def intern_many(self, names: Iterable[str]) -> list[int]:
        return [self.intern(n) for n in names]

    def lookup(self, rid: int) -> str:
        name = self._to_name[rid]
        if name is None:
            return f"_:r{rid}"
        return name

    def id_of(self, name: str) -> int:
        return self._to_id[name]

    def __contains__(self, name: str) -> bool:
        return name in self._to_id


def is_var(term: int) -> bool:
    """Variables are negative integers in the rule IR."""
    return term < 0


def var(i: int) -> int:
    """The i-th variable (i >= 1) as an IR term."""
    if i <= 0:
        raise ValueError("variable index must be >= 1")
    return -i
