"""The result line's shape, on each request kind at a size the CPU runs,
with the program and the reference on their plain torch paths."""

import json

import pytest

from port_bench import run
from port_bench.tests.tiny import run_tiny

CELLS = ["codex-bn254-p2.commit-dev-1g", "codex-gl-p2.commit-host-1g",
         "codex-bn254-p2.prove-fresh-4x256m"]


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@pytest.mark.parametrize("workload", CELLS)
def test_an_untraced_run_is_correct_and_has_the_contract_keys(workload):
    r = run_tiny(workload)
    assert json.loads(json.dumps(r)) == r
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    names = set(r["metrics"])
    assert "setup_s" in names and len(names) >= 2
    for m in r["metrics"].values():
        assert _is_number(m["value"]) and m["value"] > 0 and isinstance(m["unit"], str)
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c == {"value": 0, "limit": 0}


def test_a_traced_run_reports_per_layer_metrics_and_the_trace():
    r = run_tiny("codex-bn254-p2.prove-fresh-4x256m", trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"export_ms"}  # the CPU has no device events to read
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    assert list(r)[-1] == "checks"


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err
