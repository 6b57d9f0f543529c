"""tools_torch/scaling_bench.py on the CPU: a mesh of four `cpu` entries
(the plain versions), both fields, at a small size.

The meshes of 1, 2 and 4 devices (1 x 1, 1 x 2, 2 x 2 slots x cells) give
one dataset root, the JAX package's oracle's; every row says it ran on no
card, the summary written to --out carries the caveat that four shards on
the CPU check the sharded code and do not measure scaling.  About 17 s
alone here.
"""

import contextlib
import io
import json

import pytest

from codex_storage_proofs_circuits_tpu.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import compress_fn
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, calc_slot_tree
from tools_torch import scaling_bench as SB

CELLS, SLOTS, CELL_SIZE = 16, 2, 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = SB.main(["--device=cpu", "--n-devices=4", f"--cells={CELLS}", f"--slots={SLOTS}",
                      f"--cell-size={CELL_SIZE}", "--out", str(out)])
    return {"rc": rc, "stdout": buf.getvalue(), "summary": json.loads(out.read_text())}


def _oracle_roots() -> dict:
    glob = GlobalConfig(max_depth=32, max_log2_n_slots=8, cell_size=CELL_SIZE,
                        block_size=CELL_SIZE * 8)
    dset = DataSetConfig(n_slots=SLOTS, n_cells=CELLS, n_samples=1,
                         data_src=DataSource("fake", seed=7))
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(SLOTS)]
    bn = merkle_tree([calc_slot_tree(c).root for c in cfgs]).root
    gl = merkle_tree([calc_slot_tree_gl("poseidon2", c).root for c in cfgs],
                     compress_fn("poseidon2")).root
    return {"bn254": str(bn), "goldilocks": str(list(gl))}


def test_every_mesh_gives_the_oracles_dataset_root(run):
    assert run["rc"] == 0
    want = _oracle_roots()
    results = run["summary"]["results"]
    assert set(results) == {"bn254", "goldilocks"}
    for field, rows in results.items():
        assert [r["devices"] for r in rows] == [1, 2, 4]
        assert [r["mesh"] for r in rows] == [{"slots": 1, "cells": 1}, {"slots": 1, "cells": 2},
                                             {"slots": 2, "cells": 2}]
        assert {r["root"] for r in rows} == {want[field]}
        assert all(r["distinct_cards"] == 0 and r["wall_s"] > 0 for r in rows)
        assert rows[0]["speedup"] == 1.0


def test_summary_carries_the_caveat_and_the_rows_print(run):
    s = run["summary"]
    assert s["backend"] == "cpu" and s["n_devices"] == 4 and s["distinct_cards"] == 0
    assert "4 shards" in s["caveat"] and "not scaling" in s["caveat"]
    lines = run["stdout"].splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert rows == s["results"]["bn254"] + s["results"]["goldilocks"]
    assert lines[-1] == f"# {s['caveat']}"
