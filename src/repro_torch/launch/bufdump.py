"""The largest tensors live at a rank's memory peak in one dry-run step (a
memory debugging aid).

The port of ``repro.launch.bufdump``, which lists a compiled module's
largest HLO buffers.  Here the step of
:mod:`repro_torch.launch.dryrun` runs on fake tensors under
:class:`repro_torch.launch.costs.StepCounter`, and the storages live at its
peak are listed with their bytes, shape, dtype and the aten op that made
each (``empty`` for the step's inputs and the kernels' outputs).

Usage: PYTHONPATH=src python -m repro_torch.launch.bufdump --arch X --shape Y [--mesh single]
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--min-mib", type=float, default=256.0)
    args = ap.parse_args()

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import counted_step, fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.workloads import build_cell

    spec = get_arch(args.arch)
    multi = args.mesh == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        wl = build_cell(spec, spec.shape(args.shape), mesh)
        counter, donated, _, _ = counted_step(wl, mesh)
    mem = counter.memory(donated, keep=args.top)
    print(f"peak = {mem['peak_bytes'] / 2**30:.2f} GiB ({mem['argument_bytes'] / 2**30:.2f} "
          f"GiB of inputs), rank 0 of {mesh.size}")
    for t in mem["peak_tensors"]:
        if t["bytes"] >= args.min_mib * 2**20:
            print(f"{t['bytes'] / 2**30:8.2f} GiB  {t['dtype']}{list(t['shape'])} {t['op']}")


if __name__ == "__main__":
    main()
