"""The comparison that decides ``correct``.

Each state the traffic hands over (:meth:`outputs` of its driver) holds
the program's store, rho and explicit set as the program gave them to the
host, and the explicit set it should hold.  The plain reference works the
store and rho out again from that explicit set; the numbers compared are,
summed over the states, the facts in one store and not the other, the ids
whose representative differs (rho compared over the longer of the two,
identities past the shorter's end), the explicit facts in one set and not
the other, and the window's operations whose own counters (explicit facts,
merged resources, restarts) were off.  Each limit is 0: REW's answer is
exact.  The sets are compared with plain PyTorch on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.rew import pack
from .keys import unpack

LIMITS = {"triples_diff": 0, "rho_diff": 0, "explicit_diff": 0, "ops_failed": 0}


def sym_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements in one of two distinct-valued tensors and not the other."""
    both = int(torch.isin(a, b).sum())
    return int(a.shape[0] + b.shape[0] - 2 * both)


def rho_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    n = max(a.shape[0], b.shape[0])
    pa = torch.arange(n, dtype=torch.int64, device=a.device)
    pb = pa.clone()
    pa[: a.shape[0]] = a
    pb[: b.shape[0]] = b.to(a.device)
    return int((pa != pb).sum())


def compare(outputs: list, reference, ops_failed: int, device="cpu") -> dict:
    """``reference(explicit rows) -> (keys, rho)`` (tensors on ``device``);
    returns each number compared with its limit."""
    found = dict(triples_diff=0, rho_diff=0, explicit_diff=0, ops_failed=int(ops_failed))
    cache: dict = {}
    for out in outputs:
        key = out["explicit"].tobytes()
        if key not in cache:
            cache[key] = reference(unpack(out["explicit"]))
        want_keys, want_rho = cache[key]
        got = out["got"]

        def keys_of(rows):
            return torch.unique(pack(torch.as_tensor(np.asarray(rows, np.int32),
                                                     device=device)))

        found["triples_diff"] += sym_diff(keys_of(got["triples"]), want_keys)
        found["rho_diff"] += rho_diff(torch.as_tensor(np.asarray(got["rho"]), device=device),
                                      want_rho)
        found["explicit_diff"] += sym_diff(keys_of(got["explicit"]),
                                           torch.as_tensor(out["explicit"], device=device))
    return {k: dict(value=v, limit=LIMITS[k]) for k, v in found.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
