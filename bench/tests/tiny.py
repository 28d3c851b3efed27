"""A benchmark root at sizes the CPU runs in seconds, for the tests: the
repository's traffic mixes and metric readers copied, two small
configurations (the generator's equality-dense and join-heavy shapes at
the repository's own reduced scale, caps of 2^15) and four cells on them, in a
``BENCHMARK.json`` whose metrics are the repository's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CONFIGS = {
    "oc": dict(generator=dict(n_groups=500, group_size=8, n_spokes_per=2, n_plain=1500,
                              hierarchy_depth=3),
               expect=dict(explicit=10500, resources=5927, merged=3500),
               update_feed=dict(merge_share=0.4)),
    "up": dict(generator=dict(n_groups=2, group_size=2, n_spokes_per=1, n_plain=4000,
                              hierarchy_depth=2, chain_rules=True),
               expect=dict(explicit=5010, merged=2), update_feed=dict(merge_share=0.0)),
}
CAP = 1 << 15
SMALL_CYCLE = dict(kind="changeset_cycle", rows=64, pool=4, trace_warm=4,
                   trace_ops=4)


def make_root(tmp: Path) -> Path:
    bench = tmp / "bench"
    for sub in ("metrics", "traffic"):
        shutil.copytree(REPO / "bench" / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "traffic" / "cycle_small.json").write_text(json.dumps(SMALL_CYCLE))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg, name=name, reference="rew",
                   engine=dict(arch="sameas_rew", capacity=CAP, bind_cap=CAP,
                               out_cap=CAP, rewrite_cap=CAP))
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=name, source="https://arxiv.org/abs/1411.3622",
                                    file=f"bench/configs/{name}.json", reduced=[],
                                    why="a test's size"))
        for kind, traffic in (("rew", "rew_repeat"), ("updates", "cycle_small")):
            spec["workloads"].append(dict(name=f"{name}.{kind}", config=name,
                                          traffic=traffic, chips=1, why="a test's size"))
    for m in spec["end_to_end"] + spec["per_layer"]:  # each metric in every cell of its kind
        if "workloads" in m:
            kinds = sorted({w.split(".", 1)[1] for w in m["workloads"]})
            m["workloads"] = [f"{name}.{kind}" for kind in kinds for name in CONFIGS]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
