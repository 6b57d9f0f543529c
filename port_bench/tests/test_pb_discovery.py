"""A configuration, a traffic mix, a request kind and a per-layer metric
added as new files are found by their names, with no edit to a file that
exists (in a copy of the benchmark under a temporary directory)."""

import hashlib
import json
import os
import shutil

from port_bench import spec as SP
from port_bench.spec import HERE, ROOT


def _digests(top: str) -> dict:
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digests(str(bench))

    (bench / "configs" / "new-config.json").write_text(json.dumps(
        {"field": "goldilocks", "hash": "monolith", "cell_size": 2048, "block_size": 65536,
         "max_depth": 32, "max_slots": 256, "n_samples": 100}))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(
        {"request": "new-kind", "slot_cells": 1024, "check_cells": 16}))
    (bench / "requests" / "new-kind.py").write_text("KIND = 'new-kind'\n")
    (bench / "metrics" / "new_metric.py").write_text("def read(rec):\n    return 42.0\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "new-config", "source": "https://example.org/new",
                           "file": "port_bench/configs/new-config.json", "reduced": [],
                           "why": "a test"})
    doc["workloads"].append({"name": "new-config.new-mix", "config": "new-config",
                             "traffic": "new-mix", "chips": 1, "why": "a test"})
    doc["end_to_end"][0]["workloads"].append("new-config.new-mix")
    doc["per_layer"].append({"name": "new_metric", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "kernels",
                             "moves": "commit_gib_per_s", "workloads": ["new-config.new-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = SP.load("new-config.new-mix", root=str(root), bench_dir=str(bench))
    assert cell.config["hash"] == "monolith"
    assert cell.traffic["slot_cells"] == 1024
    assert [m["name"] for m in cell.end_to_end] == ["commit_gib_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert cell.readers["new_metric"]({}) == 42.0
    assert SP.request_kind("new-kind", str(bench)).KIND == "new-kind"
    after = _digests(str(bench))
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_of_the_benchmark_loads():
    doc = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in doc["workloads"]:
        cell = SP.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
        SP.request_kind(cell.traffic["request"])
