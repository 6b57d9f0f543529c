"""Slot trees from cell byte rows (models/hashing.py::slot_tree_from_rows,
models/gl_hashing.py::slot_tree_from_rows_gl) against the felt path they
replace on the main path (slot_tree_from_felts of the encoded cells, which
tests/test_torch_slot.py and tests/test_torch_gl_slot.py hold against the
JAX package), and the BN254 cell hash of the main path's 2048-byte cells
against the oracle.

Bit-exact; cell bytes come from the fake-data generator or numpy, seeded.
The trees are 32 cells of 64 bytes (block-tree depth 2) in two groups.
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle.slot import hash_cell_bytes
from codex_storage_proofs_circuits_tpu_torch.fields import bn254 as F
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as TH
from codex_storage_proofs_circuits_tpu_torch.models.data import gen_fake_cells
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE
from codex_storage_proofs_circuits_tpu_torch.ops import gl_encode as TGE
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as TP

BTD = 2


@pytest.mark.parametrize("field", ["bn254", "poseidon2", "monolith"])
def test_slot_tree_from_rows_equals_the_felt_path(field):
    cells = torch.from_numpy(gen_fake_cells(64, 31, np.arange(32)))
    rows = cells.T  # read in place, as models/hashing.batched_slot_layers hands them over
    if field == "bn254":
        got = TH.slot_tree_from_rows(rows, BTD, n_groups=2)
        want = TH.slot_tree_from_felts(TE.encode_cells(cells), BTD, n_groups=2)
    else:
        got = TGH.slot_tree_from_rows_gl(field, rows, BTD, n_groups=2)
        want = TGH.slot_tree_from_felts_gl(field, TGE.encode_cells(cells), BTD, n_groups=2)
    assert len(got) == len(want) == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sponge2_rows_at_2048_bytes_matches_the_oracle():
    cells = np.random.default_rng(2048).integers(0, 256, (3, 2048), dtype=np.uint8)
    got = TP.sponge2_rows(torch.from_numpy(cells.T.copy()))
    assert [F.from_mont(v) for v in TL.unpack(got)] == [hash_cell_bytes(c.tobytes()) for c in cells]
