"""The least time the card needs for each hand-written kernel's launch,
frozen here with the benchmark.

The formulas are those of the program's dry-run table
(``repro_torch/launch/costs.py``, ``KERNEL_COUNTS``) in their static form:
what a launch must read and write, from its operands' shapes as launched,
with every term that depends on the data at its least.  The search reads
its queries and writes one bound a query (the keys it must read depend on
the queries, so none are counted); the rewrite reads the rows and writes
the rewritten rows and the changed flags (the masks and the rho entries it
reads depend on the call and the data, so none are counted); the union
reads its valid flags (no row need be valid); compression reads rho (no
entry need move).  Operations count one a key, query, row or entry, at
the card's integer rate.  Bytes are at the card's HBM rate.  A share of
these bounds in a kernel's measured time cannot pass 100 % unless the
trace lost time.

Rates: one H100 SXM at 700 W, NVIDIA's datasheet: 3.35 TB/s HBM3; the
integer rate 132 SMs x 64 INT32 lanes x 1.98 GHz, as the program's table.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9

# the device functions each C entry point launches (csrc/*.cu), and the one
# launched exactly once by every launch that has work: the trace's count
# of it is the launches the trace kept
DEVICE_FUNCTIONS = {
    "dedup_order": ("radix_histogram", "radix_plan", "radix_pass"),
    "search_bounds": ("search_tile_kernel",),
    "rewrite_triples": ("rewrite_kernel",),
    "uf_compress": ("halve_kernel", "finish_kernel"),
    "uf_union": ("union_kernel",),
}
MARKER = {"dedup_order": "radix_histogram", "search_bounds": "search_tile_kernel",
          "rewrite_triples": "rewrite_kernel", "uf_compress": "halve_kernel",
          "uf_union": "union_kernel"}
# C entry point -> the kernel whose device functions it launches
KERNEL_OF_ENTRY = {"dedup_order": "dedup_order", "search_bounds": "search_bounds",
                   "prefix_range_bounds": "search_bounds",
                   "rewrite_triples": "rewrite_triples", "uf_compress": "uf_compress",
                   "uf_union": "uf_union"}


def kernel_of(device_name: str) -> str | None:
    """The hand-written kernel a device function belongs to, else None."""
    for kernel, names in DEVICE_FUNCTIONS.items():
        if any(n in device_name for n in names):
            return kernel
    return None


def _rows(shape) -> int:
    return int(shape[0]) if shape else 0


def least(entry: str, shapes: tuple) -> tuple[float, float]:
    """``(bytes, integer operations)`` one launch of C entry point
    ``entry`` must move and do, from its operands' shapes (the tensors the
    wrapper hands to ``ops.traced``)."""
    if entry == "dedup_order":  # keys in, the permutation out
        n = _rows(shapes[0])
        return 12.0 * n, float(n)
    if entry == "search_bounds":  # queries in, one int32 bound each out
        n = _rows(shapes[0])
        return 12.0 * n, float(n)
    if entry == "prefix_range_bounds":  # (n, k) int32 prefixes in, start and end out
        n, k = int(shapes[0][0]), int(shapes[0][1])
        return 4.0 * k * n + 8.0 * n, float(n)
    if entry == "rewrite_triples":  # (n, 3) int32 in and out, a changed flag out
        n = _rows(shapes[0])
        return 25.0 * n, 3.0 * n
    if entry == "uf_compress":  # rho read
        v = _rows(shapes[0])
        return 4.0 * v, float(v)
    if entry == "uf_union":  # the valid flags read
        m = _rows(shapes[1])
        return float(m), 0.0
    raise KeyError(f"no count for entry point {entry!r}")


def has_work(entry: str, shapes: tuple) -> bool:
    """Whether a launch of ``entry`` with these operands runs a kernel."""
    if entry == "uf_union":
        return _rows(shapes[0]) > 0 and _rows(shapes[1]) > 0
    return _rows(shapes[0]) > 0


def bound_s(entry: str, shapes: tuple) -> float:
    """The least seconds of one launch: the larger of its bytes at the HBM
    rate and its operations at the integer rate."""
    n_bytes, n_ops = least(entry, shapes)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S)
