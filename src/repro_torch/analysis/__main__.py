"""``python -m repro_torch.analysis`` — audit the registered units.

Modes:

  --check           audit the registered inventory at the probe geometry,
                    print violations + dispatch problems, exit nonzero on
                    any (the gate; seconds)
  --json PATH       also write the full report dict as JSON ("-" = stdout)
  --dataset NAME    probe dataset (pex | chain | clique | dbpedia_like)
  --fixture NAME    audit one planted-violation fixture instead of the
                    inventory; exits nonzero iff the expected pass fires —
                    i.e. rc != 0 means the audit is WORKING
  --list-fns        print the audited unit labels and exit
  --device DEV      where to run: cuda (the default) or cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr)


def run_fixture(name: str, json_path: str | None, device: str) -> int:
    from . import ALL_PASSES
    from .fixtures import EXPECTED_PASS, trace_fixture

    label, trace, arena_rows = trace_fixture(name, device)
    violations = []
    for p in ALL_PASSES:
        violations += p.run(label, trace, arena_rows)
    report = {
        "fixture": name,
        "device": device,
        "expected_pass": EXPECTED_PASS[name],
        "violations": [v.as_dict() for v in violations],
    }
    if json_path:
        _emit_json(report, json_path)
    for v in violations:
        print(v)
    hit = any(v.pass_name == EXPECTED_PASS[name] for v in violations)
    if not hit:
        _fail(
            f"fixture {name!r}: expected pass {EXPECTED_PASS[name]} did NOT "
            "fire — the audit has gone blind to this violation class"
        )
        # a blind audit is itself a failure, but distinguish it from the
        # found-the-plant exit
        return 2
    print(f"fixture {name!r}: {EXPECTED_PASS[name]} fired as planted")
    return 1


def _emit_json(report: dict, path: str) -> None:
    text = json.dumps(report, indent=2, sort_keys=True)
    if path == "-":
        print(text)
    else:
        with open(path, "w") as f:
            f.write(text + "\n")
        print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any violation or dispatch problem")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help='write the report as JSON ("-" for stdout)')
    ap.add_argument("--dataset", default="pex",
                    choices=["pex", "chain", "clique", "dbpedia_like"])
    ap.add_argument("--fixture", metavar="NAME", default=None,
                    help="audit a planted-violation fixture instead")
    ap.add_argument("--list-fns", action="store_true",
                    help="print the audited unit inventory and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    args = ap.parse_args(argv)

    if args.fixture:
        return run_fixture(args.fixture, args.json, args.device)

    from . import audited_fn_labels, build_probe, run_report

    if args.list_fns:
        engine, state, _ = build_probe(args.dataset, device=args.device)
        for label in sorted(audited_fn_labels(engine, state)):
            print(label)
        return 0

    report = run_report(args.dataset, device=args.device)
    if args.json:
        _emit_json(report, args.json)

    n_fns = len(report["fns"])
    violations = report["violations"]
    problems = report["dispatch"]["problems"]
    print(
        f"audited {n_fns} fns on {report['dataset']!r} "
        f"(arena {report['arena_rows']}, {report['device']}) with passes "
        f"{', '.join(report['passes'])}"
    )
    for v in violations:
        print(
            f"[{v['pass_name']}] {v['fn']}: {v['primitive']} at {v['path']}"
            f" — {v['detail']}"
        )
    for p in problems:
        print(f"[DispatchAuditor] {p}")
    print(
        f"{len(violations)} violation(s), {len(problems)} dispatch "
        f"problem(s); {report['dispatch']['total']} runtime dispatches "
        "observed"
    )
    if args.check and (violations or problems):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
