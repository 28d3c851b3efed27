"""One run of one cell: set-up, the measured window, the traced
sub-window, the check, the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration's file (``configs[].file``), its traffic mix
(``bench/traffic/<traffic>.json``, run by :mod:`bench.lib.traffic`), the
plain reference its configuration names (``bench/reference/<name>.py``)
and, for every metric the cell reports, a reader
``bench/metrics/<metric>.py`` whose ``read(ctx)`` returns the value or
None when it finds nothing to read.  A ``--trace 0`` run reports the
cell's end-to-end metrics, a ``--trace 1`` run its per-layer ones; a
per-layer metric with a ``workloads`` list is reported in those cells,
one without in every cell that reports the metric it moves.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import check, kg as kgen, trace as tr, traffic
from .census import LaunchCensus

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
RUN_DIR = Path("build") / "bench"  # each run's record, under the checkout


class Ids:
    """The benchmark's name -> id map in the shape the program's rule
    parser asks of a dictionary (every name is already known)."""

    def __init__(self, ids: dict) -> None:
        self.ids = ids

    def intern(self, name: str) -> int:
        return self.ids[name]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plan(root: Path, name: str) -> dict:
    """The cell ``name``: its entry, configuration, traffic parameters and
    the metrics it reports (end-to-end and per-layer)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in reported)]
    return dict(cell=cell, config=load_json(root / entry["file"]),
                traffic=load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json"),
                end_to_end=e2e, per_layer=layer, run_seconds=spec["run_seconds"])


def reader(root: Path, metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def reference_of(config: dict, kg, device="cpu"):
    """``explicit rows -> (keys, rho)`` by the configuration's plain
    reference, on ``device``."""
    ref = importlib.import_module(f"bench.reference.{config['reference']}")

    def run(rows: np.ndarray):
        return ref.materialise(rows, kg.rules, kg.ids, kg.n_resources, device=device)
    return run


def card_state() -> dict:
    """The card's name, clocks and power as ``nvidia-smi`` reads them."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return dict(zip(query.split(","), out.stdout.strip().splitlines()[0].split(", ")))
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return dict(error=repr(e))


class Ctx:
    """What a metric's reader reads: the window's operations and wall,
    set-up, peak memory, and in a traced run the sub-window's trace
    summary and the launch census."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


def build(config: dict, seed: int, device: str):
    """The inputs from the seed and the program's side of them."""
    import torch  # noqa: F401  (the engine's device work)
    from repro_torch import TorchEngine
    from repro_torch.configs import get_arch
    from repro_torch.core.rules import parse_program

    kg = kgen.generate(seed, **config["generator"])
    expect = config.get("expect", {})
    found = dict(explicit=int(kg.facts.shape[0]), resources=int(kg.n_resources))
    for k, v in found.items():
        if k in expect and expect[k] != v:
            raise RuntimeError(f"the configuration's {k}: generated {v}, expected {expect[k]}")
    program = parse_program(kg.rules, Ids(kg.ids))
    eng_cfg = dict(config["engine"])
    arch = eng_cfg.pop("arch")
    engine = TorchEngine.from_config(get_arch(arch).config, n_resources=kg.n_resources,
                                     device=device, **eng_cfg)
    return kg, program, engine


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda") -> dict:
    """One run; returns the result line's object and the run's record."""
    import torch
    from repro_torch.kernels import ops

    p = plan(root, name)
    census = LaunchCensus() if trace else None
    on_card = device == "cuda"
    record: dict = dict(workload=name, seed=seed, seconds=seconds, trace=trace)
    marks = {"imports": time.perf_counter() - t_process}

    tracing = ops.traced(census) if census is not None else None
    if tracing is not None:
        tracing.__enter__()
    try:
        kg, program, engine = build(p["config"], seed, device)
        driver = traffic.KINDS[p["traffic"]["kind"]](engine, kg, program, p["traffic"],
                                                     p["config"], seed)
        marks["inputs"] = time.perf_counter() - t_process
        record["setup"] = driver.setup()
        gc.collect()
        gc.freeze()  # the set-up's objects: no collection walks them in the window
        if on_card:  # the peak starts from what the window's state holds, not set-up's
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ops_done, sub, prof_recs, cuts = [], [], None, None
        graphs = lambda: list(engine._graphs.values())  # noqa: E731
        t_window = time.perf_counter()
        setup_s = t_window - t_process
        record["setup_marks"] = marks
        captures0 = engine.captures
        window_mark = census.mark(graphs()) if census is not None else None
        paused = 0.0
        if trace:
            prof_recs, sub, cuts = traced_subwindow(driver, p["traffic"], census, graphs,
                                                    ops_done, on_card)
            paused += sum(o["paused_s"] for o in ops_done)
        while time.perf_counter() - t_window - paused < seconds:
            rec = driver.step()
            paused += rec["paused_s"]
            ops_done.append(rec)
        wall = time.perf_counter() - t_window - paused
        window_end_mark = census.mark(graphs()) if census is not None else None
        peak = torch.cuda.max_memory_reserved() if on_card else 0
        window_captures = engine.captures - captures0
        record["restores_s"] = getattr(driver, "restores", [])
        t_read = time.perf_counter()
        outputs = driver.outputs()
        record["read_s"] = time.perf_counter() - t_read
    finally:
        if tracing is not None:
            tracing.__exit__(None, None, None)
    del engine, driver
    if on_card:
        torch.cuda.empty_cache()
        record["card_after"] = card_state()

    failed = sum(not o["ok"] for o in ops_done)
    t_check = time.perf_counter()
    checks = check.compare(outputs, reference_of(p["config"], kg, device), failed, device)
    record["check_s"] = time.perf_counter() - t_check
    ctx = Ctx(ops=ops_done, wall_s=wall, setup_s=setup_s, peak_bytes=peak,
              sub=sub, trace=None, sub_launches={}, window_launches={},
              lost={})
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name() if on_card else "cpu",
                       count=1, memory_peak_bytes=int(peak))
    breakdown = None
    if trace:
        ctx.window_launches = census.between(window_mark, window_end_mark)
        ctx.sub_launches = census.between(*cuts)
        summary = tr.summarise(prof_recs)
        ctx.lost = tr.lost_launches(summary, ctx.sub_launches)
        ctx.trace = None if ctx.lost else summary
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = dict(device_ops=summary.device_ops, idle_gaps=summary.idle_gaps)
        record["trace"] = dict(
            window_s=summary.window_s, busy_s=summary.busy_s, glue_s=summary.glue_s,
            port_s=summary.port_s, kept=summary.kept, lost=ctx.lost,
            per_kernel_roofline=per_kernel_shares(summary, ctx.sub_launches),
            plain_calls=census.plain_calls)
    wanted = p["per_layer"] if trace else p["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    result = dict(correct=check.passed(checks), attempted=len(ops_done), failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    record.update(window_s=wall, window_captures=window_captures,
                  ops=[{k: v for k, v in o.items() if k != "split"} for o in ops_done],
                  splits=[o["split"] for o in ops_done[:64]],
                  states_checked=[o["label"] for o in outputs], result=result)
    return record


def traced_subwindow(driver, params: dict, census, graphs, ops_done: list, on_card: bool):
    """The first operations of a traced window under ``torch.profiler``:
    ``trace_warm`` of them (the profiler's own start-up) and then
    ``trace_ops`` inside the span the summary reads.  Returns the trace's
    records, the span's operations and the census marks around it."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    def mark() -> None:  # a short kernel of the harness's on each end
        if on_card:
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        def step() -> dict:  # a host span a step: it labels the idle gaps
            with record_function(f"bench.step.{driver.next_kind()}"):
                return dict(driver.step(), profiled=True)

        for _ in range(params["trace_warm"]):
            ops_done.append(step())
        start = census.mark(graphs())
        with record_function(tr.SPAN):
            mark()
            sub = [step() for _ in range(params["trace_ops"])]
            mark()
        end = census.mark(graphs())
    ops_done.extend(sub)
    return tr.records(prof), sub, (start, end)


def per_kernel_shares(summary, launches: dict) -> dict:
    """Each hand-written kernel's share (%) of its frozen bound in its
    traced device time, for the run's record."""
    from . import costs

    bound: dict = {}
    for (entry, shapes), n in launches.items():
        k = costs.KERNEL_OF_ENTRY[entry]
        bound[k] = bound.get(k, 0.0) + n * costs.bound_s(entry, shapes)
    return {k: dict(device_s=summary.port_s.get(k, 0.0), bound_s=b,
                    share=(100.0 * b / summary.port_s[k]) if summary.port_s.get(k) else None)
            for k, b in bound.items()}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: list, t_process: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # one process with few threads: steadier host work
    p = plan(ROOT, args.workload)
    chips = p["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    record = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                 t_process)
    result = record["result"]
    out_dir = ROOT / RUN_DIR / args.workload
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"s{args.seed}-t{args.trace}.json", "w") as f:
        json.dump(record, f, default=str)
    print(json.dumps({k: record.get(k) for k in (
        "setup_marks", "setup", "window_s", "window_captures", "restores_s", "read_s", "check_s",
        "states_checked", "card_after", "trace")}), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
