"""Triples as packed int64 keys on the host: 21 bits an id, (s, p, o)."""

from __future__ import annotations

import numpy as np

BITS = 21
MASK = (1 << BITS) - 1


def pack(rows: np.ndarray) -> np.ndarray:
    r = np.asarray(rows, np.int64).reshape(-1, 3)
    return (r[:, 0] << (2 * BITS)) | (r[:, 1] << BITS) | r[:, 2]


def unpack(keys: np.ndarray) -> np.ndarray:
    k = np.asarray(keys, np.int64)
    return np.stack([k >> (2 * BITS), (k >> BITS) & MASK, k & MASK],
                    axis=1).astype(np.int32)


def member(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Which ``keys`` occur in the sorted ``sorted_keys``."""
    if sorted_keys.shape[0] == 0:
        return np.zeros(keys.shape[0], dtype=bool)
    pos = np.searchsorted(sorted_keys, keys).clip(max=sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == keys
