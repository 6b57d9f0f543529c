"""What one cell is: its entries in BENCHMARK.json and the files they name.

Everything that belongs to one configuration, traffic mix, request kind or
per-layer metric sits in a file of its own, found by the name
BENCHMARK.json gives:

  configs/<config>.json     the configuration (the workload's `config`
                            entry names the file)
  traffic/<traffic>.json    the traffic mix's parameters
  requests/<request>.py     the request kind a mix names (`"request"`)
  metrics/<metric>.py       the reader of a per-layer metric: read(rec)

so a cell, a mix or a metric is added by adding files and entries, with no
edit to a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Spec:
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list[dict]  # this cell's end-to-end metrics
    per_layer: list[dict]  # this cell's per-layer metrics
    readers: dict = field(default_factory=dict)  # per-layer metric name -> read(rec)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _module(path: str, name: str):
    safe = "port_bench_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(safe, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def request_kind(name: str, bench_dir: str = HERE):
    """The module of a request kind: requests/<name>.py."""
    return _module(os.path.join(bench_dir, "requests", f"{name}.py"), f"request_{name}")


def load(workload: str, root: str = ROOT, bench_dir: str = HERE) -> Spec:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    readers = {m["name"]: _module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                                  f"metric_{m['name']}").read
               for m in per_layer}
    return Spec(w, config, traffic, e2e, per_layer, readers)
