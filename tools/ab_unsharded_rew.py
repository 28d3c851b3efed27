"""Time the unsharded full-size REW path of one tree of this repository.

    python tools/ab_unsharded_rew.py TREE [--reruns N] [--out FILE]

``TREE`` is a checkout of this repository (``.`` for this one, or an
unpacked ``git archive`` of another commit).  The script imports that
tree's ``repro_torch`` and ``chip_smoke`` (so each tree runs its own
engine and its own kernels, built into its own ``build/kernels``), makes
``chip_smoke``'s OpenCyc-scale KG (2,398,800 triples, 971,865 resources),
and on the card times the default engine at ``chip_smoke``'s full-size
caps (2^22): the first run, ``N`` reruns, and the 8 events of
``chip_smoke``'s full-size update stream applied to the first run's
state.  It appends one JSON line, ``{"tree", "card", "first_s",
"reruns_s", "events"}``, to ``FILE`` (``build/ab_rew.jsonl`` by
default) and prints it.

To compare two commits, run their trees one after another on the same
card, in the order parent, change, change, parent, and compare readings
within such a sequence only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("--reruns", type=int, default=7)
    ap.add_argument("--out", default="build/ab_rew.jsonl")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no card: this script times the card")
    import chip_smoke as cs
    from repro_torch.data.generator import sample_update_stream
    from repro_torch.kernels import _build

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kg = cs.full_kg()
    facts, program, dic = kg["facts"], kg["program"], kg["dic"]
    eng = cs.full_engine(dic.n_resources)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    state, first = timed(lambda: eng.materialise_state(facts, program))
    reruns = []
    for _ in range(args.reruns):
        del state
        state, wall = timed(lambda: eng.materialise_state(facts, program))
        reruns.append(wall)
    events = []
    for op, delta in sample_update_stream(facts, dic, **cs.INC_FULL_EVENTS):
        _, wall = timed(lambda: cs.apply_event(eng, state, op, delta))
        events.append([op, wall])
    line = json.dumps(dict(tree=args.tree, card=card, first_s=first,
                           reruns_s=reruns, events=events))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
