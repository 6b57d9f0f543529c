"""bench_torch.py, the port's twin of bench.py, on the CPU.

One `--small --device=cpu` run (the plain versions) serves every test: it
prints one JSON line with bench.py's keys (vs_baseline aside, which bench.py
takes from a TPU target), writes its metric set to --out, and its three
small slot roots (BN254, GL Poseidon2, GL Monolith) equal the JAX package's
oracle (pure Python) for the same SlotConfig.  Without a card the default
--device=cuda exits non-zero.  About 25 s alone here.
"""

import contextlib
import io
import json

import pytest
import torch

import bench_torch
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig, calc_slot_tree

BENCH_KEYS = {"metric", "value", "unit", "extra"}  # bench.py's, vs_baseline aside
EXTRA_KEYS = {  # bench.py's extra, every key
    "slot_root_wall_s", "slot_mb", "gl_compress_per_s", "gl_slot_root_wall_s",
    "monolith_compress_per_s", "monolith_slot_root_wall_s", "slot_root_cold_s",
    "gl_slot_root_cold_s", "bn254_pipeline_efficiency", "gl_pipeline_efficiency",
    "monolith_pipeline_efficiency", "consistency",
}
SMALL = SlotConfig(cell_size=256, block_size=2048, n_cells=64, n_samples=1,
                   data_src=DataSource("fake", seed=12345))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "metrics.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--small", "--device=cpu", "--out", str(out)])
    return {"rc": rc, "stdout": buf.getvalue(), "out": out}


def test_small_run_prints_one_json_line_with_bench_keys(run):
    assert run["rc"] == 0
    lines = run["stdout"].splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS
    assert set(line["extra"]) == EXTRA_KEYS
    assert "[cpu]" in line["metric"] and line["unit"] == "compress/s"
    assert line["value"] > 0
    for key in EXTRA_KEYS - {"consistency", "slot_mb"}:
        assert line["extra"][key] > 0, key
    assert line["extra"]["slot_mb"] == SMALL.cell_size * SMALL.n_cells / 1e6


def test_small_roots_equal_the_jax_oracle(run):
    m = json.loads(run["out"].read_text())
    assert m["slot_root"]["slot_root"] == str(calc_slot_tree(SMALL).root)
    assert m["gl_slot_root"]["gl_slot_root"] == [
        str(v) for v in calc_slot_tree_gl("poseidon2", SMALL).root]
    assert m["monolith_slot_root"]["monolith_slot_root"] == [
        str(v) for v in calc_slot_tree_gl("monolith", SMALL).root]


def test_metrics_file_has_the_full_set(run):
    m = json.loads(run["out"].read_text())
    assert m["backend"] == "cpu" and m["card"] is None
    assert m["compress"]["batch"] == 1 << 10 and m["gl_compress"]["batch"] == 1 << 9
    for rate in (m["compress"], m["gl_compress"], m["gl_compress"]["monolith_detail"]):
        assert rate["per_iter_min_s"] <= rate["per_iter_s"] and rate["window_s"] >= 0.05
    for key in ("slot_root", "gl_slot_root", "monolith_slot_root"):
        assert m[key]["stages"]["chunks"] == 2 and m[key]["stages"]["cells"] == 64
        assert m[key]["pipeline_efficiency"] > 0


def test_cuda_without_a_card_exits_nonzero(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_torch.main(["--out", str(tmp_path / "m.json")])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "m.json").exists()
