"""Host-side packing of (s, p, o) triples into int64 sort keys.

The port's copy of the numpy helpers in ``repro.core.triples``: 21 bits per
position, subject in the high bits, so packed keys sort lexicographically.
"""

from __future__ import annotations

import numpy as np

_SHIFT_S = 42
_SHIFT_P = 21


def pack(spo: np.ndarray) -> np.ndarray:
    """(n,3) int -> (n,) int64 lexicographic sort key."""
    s = spo[:, 0].astype(np.int64)
    p = spo[:, 1].astype(np.int64)
    o = spo[:, 2].astype(np.int64)
    return (s << _SHIFT_S) | (p << _SHIFT_P) | o


def unpack(keys: np.ndarray) -> np.ndarray:
    mask = (1 << 21) - 1
    s = (keys >> _SHIFT_S) & mask
    p = (keys >> _SHIFT_P) & mask
    o = keys & mask
    return np.stack([s, p, o], axis=1).astype(np.int32)


def dedup_rows(spo: np.ndarray) -> np.ndarray:
    """Distinct triples of an (n, 3) batch, first occurrence order kept."""
    spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
    if spo.shape[0] == 0:
        return spo
    _, idx = np.unique(pack(spo), return_index=True)
    return spo[np.sort(idx)]
