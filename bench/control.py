"""The check's control for a cell: the plain reference with one of its
configuration's guarantees broken, put in the program's place at the
cell's own size, through the same comparison as a run.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 [--events N]

For a ``rew_repeat`` cell the control materialises without rewriting the
store after a merge (facts stored before it keep outdated resources); for
a ``changeset_cycle`` cell it deletes without retracting what the deleted
facts derived.  The states compared are those a run compares: the sampled
events of the seed's window and the last of ``--events`` events.  It needs
no card (``--device cpu``).  Prints one JSON line a seed with every number
compared and whether the control came out correct (it must not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.lib import changesets, check, harness, kg as kgen, keys as hk, traffic  # noqa: E402
from bench.reference import rew  # noqa: E402


def _got(keys: torch.Tensor, rho: torch.Tensor, explicit: np.ndarray) -> dict:
    return dict(triples=rew.unpack(keys).cpu().numpy(), rho=rho.cpu().numpy(),
                explicit=hk.unpack(explicit))


def control_outputs(p: dict, kg, seed: int, events: int, device="cpu") -> list:
    """The states a run of the cell compares, as the control makes them."""
    config, params = p["config"], p["traffic"]

    def closure(keys: np.ndarray):
        return rew.materialise(hk.unpack(keys), kg.rules, kg.ids, kg.n_resources,
                               device=device)

    if params["kind"] == "rew_repeat":
        explicit = np.unique(hk.pack(kg.facts))
        keys, rho = rew.materialise(kg.facts, kg.rules, kg.ids, kg.n_resources,
                                    sweep=False, device=device)
        return [dict(label="last run", got=_got(keys, rho, explicit), explicit=explicit)]
    cyc = traffic.ChangesetCycle(None, kg, None, params, config, seed)
    out = []
    for n in sorted(cyc.sampled | {events - 1}):
        i, kind, _, rows = cyc._event(n)
        want = changesets.expected_explicit(cyc.base, cyc.pool, i, kind)
        if kind in ("add_a", "add_b"):  # adds are made right
            keys, rho = closure(want)
        else:  # the delete keeps what the deleted facts derived
            before = (changesets.expected_explicit(cyc.base, cyc.pool, i, "add_a")
                      if kind == "delete_a" else cyc.base)
            keys, rho = rew.delete_without_retraction(*closure(before), rows)
        out.append(dict(label=f"event {n} ({kind} of entry {i})",
                        got=_got(keys, rho, want), explicit=want))
    return out


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--events", type=int, default=300,
                    help="events of the window whose last state is compared")
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)
    p = harness.plan(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        kg = kgen.generate(seed, **p["config"]["generator"])
        outputs = control_outputs(p, kg, seed, args.events, args.device)
        checks = check.compare(outputs, harness.reference_of(p["config"], kg, args.device),
                               0, args.device)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              states=[o["label"] for o in outputs],
                              correct=check.passed(checks), checks=checks,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
