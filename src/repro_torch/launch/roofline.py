"""Roofline over the dry run's records, for the H100.

The port of ``repro.launch.roofline``.  It reads
``build/dryrun/*__<mesh>.json`` (:mod:`repro_torch.launch.dryrun`) and
derives, per (arch x shape), from one rank's counts:

  compute_s    = FLOPs by kind / the H100's peak for the kind: bf16
                 products at 989 TFLOP/s, f32 at 67 TFLOP/s (FFMA: the
                 port runs f32 products with TF32 off), the integer
                 kernels' operations at 16.7 T/s (132 SMs x 64 INT32
                 lanes x 1.98 GHz: derived, the datasheet gives none)
  memory_s     = bytes / 3.35 TB/s
  collective_s = each axis group's wire bytes / the link rate a card gets
                 in that group, all-reduce counted twice (a ring moves its
                 operand out and back), summed over the groups

The link model (every constant the "H100 SXM datasheet, 700 W" of
:data:`repro_torch.launch.costs.HW`, none measured): a DGX H100 node
holds 8 cards joined by NVLink 4, 450 GB/s a direction; across nodes each
card has a 400 Gb/s NDR port, 50 GB/s.  Ranks sit row-major, 8 a node, so
an axis group whose ranks span nodes is charged at 50 GB/s.  On (data 16,
model 16) every group spans nodes: ``model``'s 16 ranks fill two nodes
and ``data``'s sit one a node.

As in the reference:

  model_flops_ratio = MODEL_FLOPS / (counted FLOPs x ranks): how much of
      the counted compute is useful (remat, gathered heads and attention
      beyond 6ND show here),
  roofline_frac = useful compute time / the dominant term, the useful
      time at the peak of the cell's main dtype: 1.0 means the step runs
      at the roofline on its dominant resource doing only model math.

Usage:
  python -m repro_torch.launch.roofline [--dir build/dryrun] [--mesh single]
  python -m repro_torch.launch.roofline --json
  python -m repro_torch.launch.roofline --compact   # PERF.md's table
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.costs import HW, RATE
from repro_torch.launch.dryrun import ART_DIR

# wire bytes per operand byte: a ring all-reduce moves ~2x (reduce-scatter
# then all-gather phases); the others ~1x
WIRE_WEIGHT = {"all_reduce": 2.0, "all_reduce_max": 2.0, "all_reduce_min": 2.0}


def load_cells(art_dir: str, mesh: str = "single") -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(art_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def analyse(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    n = rec["n_devices"]
    kinds = rec["cost"]["flops_by_kind"]
    compute_s = sum(v / RATE[k] for k, v in kinds.items())
    memory_s = rec["cost"]["bytes_per_dev"] / HW["hbm_bytes_per_s"]
    coll = rec["collectives"]
    by_link: dict = {}
    collective_s = 0.0
    for key, v in coll["by_kind"].items():
        axes, op = key.split(":")
        link = coll["links"][axes]
        wire = v["bytes"] * WIRE_WEIGHT.get(op, 1.0)
        collective_s += wire / link["bytes_per_s"]
        tag = "NVLink" if link["nodes"] == 1 else "network"
        by_link[tag] = by_link.get(tag, 0.0) + wire
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    model_flops = rec.get("model_flops_global", 0.0)
    counted = sum(v for k, v in kinds.items() if k != "int") * n
    main = max((k for k in kinds if k != "int"), key=lambda k: kinds[k], default="bf16")
    useful_s = model_flops / (n * RATE[main])
    dom_s = terms[dominant]
    mem = rec["memory"]
    return {
        "cell": f"{rec['arch']}:{rec['shape']}",
        "mesh": rec["mesh"],
        "n_devices": n,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "counted_flops_global": counted,
        "model_flops_ratio": model_flops / counted if counted else None,
        "roofline_frac": useful_s / dom_s if dom_s > 0 else 0.0,
        "peak_mem_gb": mem["peak_bytes"] / 1e9,
        "fits_hbm": mem["fits_hbm"],
        "wire_bytes_by_link": by_link,
    }


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def _ratio(x) -> str:
    return "-" if x is None else f"{x:.2f}"  # no product counted (the FM's gathers)


def markdown_table(rows: list[dict], skipped: list[dict], errors: list[dict] = ()) -> str:
    out = [
        "| cell | devs | compute | memory | collective | dominant | model/counted FLOPs "
        "| roofline frac | peak GB (fits 80) | wire GB: NVLink / network |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        w = r["wire_bytes_by_link"]
        out.append(
            f"| {r['cell']} | {r['n_devices']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {_ratio(r['model_flops_ratio'])} "
            f"| {r['roofline_frac']:.3f} "
            f"| {r['peak_mem_gb']:.2f} ({'y' if r['fits_hbm'] else 'N'}) "
            f"| {w.get('NVLink', 0.0) / 1e9:.3f} / {w.get('network', 0.0) / 1e9:.3f} |")
    for s in skipped:
        out.append(f"| {s['arch']}:{s['shape']} | - | - | - | - | - | - | - | "
                   f"skipped: {s.get('skip_reason', '')[:60]} | - |")
    for e in errors:
        out.append(f"| {e['arch']}:{e['shape']} | - | - | - | - | - | - | - | "
                   f"error: {(e.get('error_tail') or [''])[-1][:60]} | - |")
    return "\n".join(out)


def compact_table(rows: list[dict], skipped: list[dict]) -> str:
    """The table without the device and wire columns (every cell of one
    sweep has the same ranks), a peak over 80 GB marked, the skips on one
    line: PERF.md's form."""
    out = ["| cell | compute | memory | collective | dominant | model / counted FLOPs "
           "| roofline frac | peak GB |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['cell']} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | {r['dominant']} | {_ratio(r['model_flops_ratio'])} "
            f"| {r['roofline_frac']:.3f} | {r['peak_mem_gb']:.2f}"
            f"{'' if r['fits_hbm'] else ' **N**'} |")
    if skipped:
        names = ", ".join(f"{s['arch']}:{s['shape']}" for s in skipped)
        out.append(f"\nSkipped: {names} ({skipped[0].get('skip_reason', '')}).")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ART_DIR)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--compact", action="store_true", help="PERF.md's form")
    args = ap.parse_args()

    rows, skipped, errors = [], [], []
    for rec in load_cells(args.dir, args.mesh):
        if rec.get("status") == "skipped":
            skipped.append(rec)
        elif rec.get("status") == "error":
            errors.append(rec)
        else:
            rows.append(analyse(rec))
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print(compact_table(rows, skipped) if args.compact else markdown_table(rows, skipped, errors))
    if errors:
        print(f"\n{len(errors)} cells in error state:")
        for e in errors:
            print(f"  {e['arch']}:{e['shape']}:{e['mesh']}")


if __name__ == "__main__":
    main()
