"""Run one benchmark cell as ``bench/run.py`` does, with the program's spans
on or off, and read its trace by the program's spans.

    python3 tools/bench_spans.py --workload CELL --seed N --seconds S
                                 --spans 0|1 --trace 0|1 [--out FILE]

``--spans 1`` turns the program's spans on (``repro_torch.core.spans``)
before the cell's inputs are built, so every graph is captured with its
stage markers.  ``--trace 1`` runs the cell's traced sub-window; its
summary then leaves the program's markers and the device side of its
ranges out (``bench.lib.spans.strip``), as it leaves out the harness's
own, so the cell's per-layer metrics read the same work with the spans on
as off, and its idle gaps carry the program's span names.  The line adds
the per-span table of the sub-window (``bench.lib.spans.attribute``), the
device ms an operation in each round stage, the share of the glue that
falls into a leaf, the padding share of the sorted keys over the run's
first 64 operations, and the share of the idle time the breakdown labels
with a harness step.  Every line also gives the mean host ms a change set
blocks in reads by maintenance phase (``phase_wait_ms``, from the
program's ``last_split``, the run's first 64 unprofiled change sets) and
each graph the engine captured with the stage markers it replays
(``graphs``, from ``TorchEngine.captured_graphs()``).  ``--spans 1
--trace 0`` against ``--spans 0 --trace 0`` on the same seeds is what the
spans cost when on.

The benchmark itself reads none of this: its harness neither turns the
spans on nor keeps the profiler's events.  A benchmark change that makes
``bench/lib/harness.py`` and ``bench/lib/trace.py`` do so (calling
``bench.lib.spans`` as this script does) replaces this script.

It prints one JSON line, the card's name and power limit in it, and
appends it to ``FILE`` (default ``build/bench_spans.jsonl``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here, as bench/run.py does

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STAGES = ("rew.merge", "rew.sweep", "rew.dedup", "rew.join", "rew.flags",
          "maint.tomb_join", "maint.od_step")


def run(root: Path, workload: str, seed: int, seconds: float, spans_on: bool,
        trace: bool, t_process: float, device: str = "cuda") -> dict:
    """One run of ``workload`` under ``root``; returns the line's object."""
    from bench.lib import harness, spans as bspans, trace as tr
    from repro_torch.core import spans

    kept: dict = {}
    records, summarise, build = tr.records, tr.summarise, harness.build

    def keep(prof):
        kept["events"] = bspans.events(prof)
        return records(prof)

    def keep_engine(*args):
        kg, program, engine = build(*args)
        kept["engine"] = engine
        return kg, program, engine

    spans.enable(spans_on)
    tr.records = keep
    tr.summarise = lambda recs, span=tr.SPAN: summarise(bspans.strip(recs), span)
    harness.build = keep_engine
    try:
        record = harness.run(root, workload, seed, seconds, trace, t_process, device)
    finally:
        tr.records, tr.summarise, harness.build = records, summarise, build
        spans.enable(False)
    graphs = [dict(family=g["family"], key=repr(g["key"]), replays=g["replays"],
                   stages=g["stages"]) for g in kept.pop("engine").captured_graphs()]
    result = record["result"]
    out = dict(workload=workload, seed=seed, spans=spans_on, trace=trace,
               correct=result["correct"], failed=result["failed"],
               attempted=result["attempted"], device=result["device"],
               metrics={k: v["value"] for k, v in result["metrics"].items()},
               phase_wait_ms=bspans.phase_wait_ms(record["ops"][:len(record["splits"])],
                                                  record["splits"]),
               graphs=graphs,
               card=harness.card_state() if device == "cuda" else None)
    if trace:
        sub = [o for o in record["ops"] if o.get("profiled")]
        n_sub = harness.plan(root, workload)["traffic"]["trace_ops"]
        try:
            report = bspans.attribute(kept["events"])
        except (ValueError, KeyError, StopIteration) as e:  # keep the run's line
            out.update(report_error=repr(e), events=len(kept["events"]))
            return out
        gaps = result["breakdown"]["idle_gaps"]
        idle = record["trace"]["window_s"] - record["trace"]["busy_s"]
        out.update(
            spans_table=report,
            stage_ms={s: bspans.stage_ms(report, s, n_sub) for s in STAGES},
            glue_leaf_share=bspans.leaf_share(report),
            pad_share=bspans.pad_share(record["splits"]),
            sort_keys=[s.get("sort_keys") for s in record["splits"][:8]],
            step_idle_share=(100.0 * sum(t for n, t in gaps if n.startswith("bench.step."))
                             / idle if idle else None),
            breakdown=result["breakdown"], profiled_ops=len(sub))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="build/bench_spans.jsonl")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no card: the benchmark's cells run on the card")
    torch.set_num_threads(1)  # as bench/run.py
    line = run(ROOT, args.workload, args.seed, args.seconds, bool(args.spans),
               bool(args.trace), T_PROCESS)
    text = json.dumps(line, default=str)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
