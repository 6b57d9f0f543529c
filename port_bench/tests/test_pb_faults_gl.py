"""The GL prove cell at a size the CPU runs: a clean run is correct and its
traced run reports the cell's per-layer metrics; each fault planted in the
program underneath a run makes `correct` false, with the count that should
catch it above its limit."""

import dataclasses

import pytest

from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.oracle import goldilocks_pipeline as GPL
from port_bench.tests.test_pb_imports import _loaded
from port_bench.run import BANNED
from port_bench.tests.tiny import run_tiny

PROVE_GL = "codex-gl-p2-prove.prove-gl-fresh-4x1g"
METRICS = {"slots_ms.gl", "sample_ms.gl", "cells_ms.gl", "paths_ms.gl", "export_ms"}

_real_export = GPL.export_proof_input_gl
_real_sample = GH.sample_indices_gl


def _export_with(change):
    def export(path, pi):
        return _real_export(path, change(pi))

    return export


def _bump(d):
    return (d[0] ^ 1,) + tuple(d[1:])


def _bump_cell(pi):
    cells = [list(c) for c in pi.cell_data]
    cells[-1][0] = _bump(cells[-1][0])
    return dataclasses.replace(pi, cell_data=cells)


def _bump_path(pi):
    paths = [list(p) for p in pi.merkle_paths]
    paths[0][1] = _bump(paths[0][1])
    return dataclasses.replace(pi, merkle_paths=paths)


def _half_samples(pi):
    k = len(pi.cell_data) // 2
    return dataclasses.replace(pi, cell_data=pi.cell_data[:k], merkle_paths=pi.merkle_paths[:k])


def _sample_without_entropy(hash_fun, entropy, root, n_samples, log2n):
    return _real_sample(hash_fun, (0, 0, 0, 0), root, n_samples, log2n)


FAULTS = {
    "a sampled cell's felt altered": (
        GPL, "export_proof_input_gl", _export_with(_bump_cell), "cell_mismatches"),
    "a path sibling altered": (
        GPL, "export_proof_input_gl", _export_with(_bump_path), "path_mismatches"),
    "half of the samples left out": (
        GPL, "export_proof_input_gl", _export_with(_half_samples), "cell_mismatches"),
    "the dataset root altered": (
        GPL, "export_proof_input_gl",
        _export_with(lambda pi: dataclasses.replace(pi, data_set_root=_bump(pi.data_set_root))),
        "field_mismatches"),
    "sampling that ignores the entropy": (
        GH, "sample_indices_gl", _sample_without_entropy, "cell_mismatches"),
    "a slot root altered": (
        GPL, "export_proof_input_gl",
        _export_with(lambda pi: dataclasses.replace(pi, slot_root=_bump(pi.slot_root))),
        "field_mismatches"),
}


def test_a_clean_run_is_correct():
    r = run_tiny(PROVE_GL)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"proof_p50_ms", "proof_p90_ms", "setup_s"}
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())


def test_a_traced_run_reports_the_gl_proof_metrics():
    r = run_tiny(PROVE_GL, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == METRICS
    assert all(m["value"] > 0 and m["unit"] == "ms" for m in r["metrics"].values())


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    module, name, fake, count = FAULTS[fault]
    monkeypatch.setattr(module, name, fake)
    r = run_tiny(PROVE_GL)
    assert r["correct"] is False
    assert r["checks"][count]["value"] > r["checks"][count]["limit"], r["checks"]


def test_the_request_kind_loads_no_jax():
    loaded = _loaded(
        "from port_bench import spec\n"
        "from port_bench.tests.tiny import tiny_spec\n"
        f"s = spec.load({PROVE_GL!r})\n"
        f"spec.request_kind(s.traffic['request']).Client(tiny_spec({PROVE_GL!r}), 1, 'cpu', '.')\n")
    assert not loaded & set(BANNED)
