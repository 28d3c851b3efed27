"""Planted-violation fixtures: small torch functions each pass must catch.

The port of ``repro.analysis.fixtures``.  Every fixture reproduces, in
miniature, the bug class its pass exists to block, at the probe geometry
(``ARENA`` rows against ``CAP``-wide streams), and trips that pass only.
The CLI's ``--fixture NAME`` mode and ``tests/test_torch_analysis.py``
record them and check that the expected pass fires with a location; a pass
that stops seeing its fixture has gone blind, whatever the inventory says.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops

from .passes import record

ARENA = 4096   # the "arena" length of the toy functions
CAP = 256      # delta-stream width, strictly smaller


def arena_sort(keys, q):
    """Plants a NoArenaSort violation: re-sorts the full arena per probe
    instead of keeping the persistent sorted index."""
    perm = torch.argsort(keys)                     # <- arena-length sort
    srt = keys[perm]
    pos = torch.searchsorted(srt, q)
    return srt[pos.clamp(0, ARENA - 1)] == q


def arena_scatter(dst, vals):
    """Plants a NoArenaScatter violation: an arena-length update stream,
    the write traffic the stable partition and rank-merge avoid."""
    idx = torch.arange(ARENA, device=dst.device)
    return dst.scatter_reduce(0, idx, vals, "amax")  # <- arena-length scatter


def int32_key(s, p, o):
    """Plants a DtypeSafety violation: packs 3 x 21-bit IDs into an int64
    (the engine's ``_pack3`` idiom), then casts the key down — identical on
    small test IDs, corrupt beyond 2^31."""
    key = ((s.to(torch.int64) << 42) | (p.to(torch.int64) << 21)
           | o.to(torch.int64))
    return key.to(torch.int32)                     # <- silent truncation


def host_callback(x):
    """Plants a NoHostCallback violation: a debug read left in a hot unit."""
    x[0].item()                                    # <- host round trip
    return x * 2


def nested_cond_sort(keys, q, flag):
    """Plants an arena sort one level down, in a branch chosen on the
    device.

    Both branches run and ``torch.where`` picks one (the eager form of the
    reference's ``lax.cond``, whose branches it traces), and the sort goes
    through the ``dedup_order`` wrapper: the record has it inside the plain
    version's scope on the CPU and as the kernel's launch on the card, not
    at the top.
    """
    perm = ops.dedup_order(keys).to(torch.int64)   # <- sort inside a branch
    probe = keys[perm][q.clamp(0, ARENA - 1).reshape(1)]
    return torch.where(flag, probe, torch.zeros_like(probe))


FIXTURES = (
    "arena_sort", "arena_scatter", "int32_key", "host_callback",
    "nested_cond_sort",
)

# the pass each fixture must trip — the CLI asserts the report names it
EXPECTED_PASS = {
    "arena_sort": "NoArenaSort",
    "arena_scatter": "NoArenaScatter",
    "int32_key": "DtypeSafety",
    "host_callback": "NoHostCallback",
    "nested_cond_sort": "NoArenaSort",
}


def trace_fixture(name: str, device: str = "cuda"):
    """Record a fixture by name on ``device``; returns ``(label, trace,
    arena_rows)``."""
    dev = resolve(device, "trace_fixture")
    i64, i32 = torch.int64, torch.int32

    def z(n, dtype):
        return torch.zeros(n, dtype=dtype, device=dev)

    runs = {
        "arena_sort": lambda: arena_sort(z(ARENA, i64), z(CAP, i64)),
        "arena_scatter": lambda: arena_scatter(z(ARENA, i32), z(ARENA, i32)),
        "int32_key": lambda: int32_key(z(CAP, i32), z(CAP, i32), z(CAP, i32)),
        "host_callback": lambda: host_callback(z(CAP, i32)),
        "nested_cond_sort": lambda: nested_cond_sort(
            z(ARENA, i64), z((), i64), z((), torch.bool)),
    }
    if name not in runs:
        raise ValueError(f"unknown fixture {name!r} (have {FIXTURES})")
    return f"fixture:{name}", record(runs[name]), ARENA
