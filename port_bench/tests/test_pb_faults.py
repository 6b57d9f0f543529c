"""The judge catches a broken program: each fault a cell can have is
planted in the program underneath a run (the look for a card skipped, at a
size the CPU runs), and `correct` comes out false, with the count that
should catch it above its limit.  One card holds every cell, so no cell
has an exchange between chips to leave out."""

import dataclasses

import pytest
import torch

from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as H
from codex_storage_proofs_circuits_tpu_torch.models import proof_input as PI
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.utils import json_export
from port_bench.tests.tiny import run_tiny

BN_DEV = "codex-bn254-p2.commit-dev-1g"
GL_FILE = "codex-gl-p2.commit-host-1g"
PROVE = "codex-bn254-p2.prove-fresh-4x256m"


def _zero_hashes(rows):
    """A step that returns its state unchanged: no cell is absorbed."""
    return torch.zeros((16, rows.shape[1]), dtype=torch.int32, device=rows.device)


def _half_hashes(rows):
    """Half of the batch left out: the first half's hashes stand for all."""
    b = rows.shape[1]
    h = _real_hash_cells_rows(rows[:, : b // 2])
    return torch.cat([h, h], 1)


_real_hash_cells_rows = H.hash_cells_rows
_real_root = S.streaming_slot_root
_real_root_gl = S.streaming_slot_root_gl
_real_rows_tree_gl = GH.slot_tree_from_rows_gl
_real_export = json_export.export_proof_input
_real_sample = PI.sample_cell_indices


def _half_rows_gl(hash_fun, rows, btd):
    rows = rows.clone()
    rows[:, rows.shape[1] // 2:] = 0
    return _real_rows_tree_gl(hash_fun, rows, btd)


def _stale_cells(cfg, idx):
    import numpy as np

    return np.zeros((len(idx), cfg.cell_size), dtype=np.uint8)


def _export_with(change):
    def export(path, pi):
        return _real_export(path, change(pi))

    return export


def _bump_path(pi):
    paths = [list(p) for p in pi.merkle_paths]
    paths[0][1] += 1
    return dataclasses.replace(pi, merkle_paths=paths)


def _bump_cell(pi):
    cells = [list(c) for c in pi.cell_data]
    cells[-1][0] ^= 1
    return dataclasses.replace(pi, cell_data=cells)


def _half_samples(pi):
    k = len(pi.cell_data) // 2
    return dataclasses.replace(pi, cell_data=pi.cell_data[:k], merkle_paths=pi.merkle_paths[:k])


def _bump_dataset_root(pi):
    return dataclasses.replace(pi, data_set_root=pi.data_set_root + 1)


FAULTS = {
    "bn254 commit: cell hash returns its state": (
        BN_DEV, H, "hash_cells_rows", _zero_hashes, "leaf_mismatches"),
    "bn254 commit: half of the cells hashed": (
        BN_DEV, H, "hash_cells_rows", _half_hashes, "leaf_mismatches"),
    "bn254 commit: root altered": (
        BN_DEV, S, "streaming_slot_root", lambda *a, **k: _real_root(*a, **k) + 1,
        "root_mismatches"),
    "gl file commit: reads return nothing new": (
        GL_FILE, S.D, "load_cells", _stale_cells, "leaf_mismatches"),
    "gl file commit: half of the cells' bytes dropped": (
        GL_FILE, GH, "slot_tree_from_rows_gl", _half_rows_gl, "leaf_mismatches"),
    "gl file commit: root altered": (
        GL_FILE, S, "streaming_slot_root_gl",
        lambda *a, **k: (_real_root_gl(*a, **k)[0] ^ 1,) + _real_root_gl(*a, **k)[1:],
        "root_mismatches"),
    "prove: a path sibling altered": (
        PROVE, json_export, "export_proof_input", _export_with(_bump_path), "path_mismatches"),
    "prove: a cell's felt altered": (
        PROVE, json_export, "export_proof_input", _export_with(_bump_cell), "cell_mismatches"),
    "prove: half of the samples left out": (
        PROVE, json_export, "export_proof_input", _export_with(_half_samples),
        "cell_mismatches"),
    "prove: the dataset root altered": (
        PROVE, json_export, "export_proof_input", _export_with(_bump_dataset_root),
        "field_mismatches"),
    "prove: sampling returns its state, whatever the entropy": (
        PROVE, PI, "sample_cell_indices", lambda e, r, n, k: list(range(k)), "cell_mismatches"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    workload, module, name, fake, count = FAULTS[fault]
    monkeypatch.setattr(module, name, fake)
    r = run_tiny(workload)
    assert r["correct"] is False
    assert r["checks"][count]["value"] > r["checks"][count]["limit"], r["checks"]
