"""The port's BN254 cell hash from byte rows (ops/poseidon2_plain.py::
sponge2_rows, the plain version of kernel K2's byte-row entry, and the
wrapper ops/poseidon2_cuda.py::sponge2_rows, which takes it for CPU
tensors) against the JAX package and the oracle.

Bit-exact; cell bytes are made with numpy from a seed.  The JAX side is
models/hashing.py::hash_cells_mont on ops/encode.py::encode_cells_device of
the same bytes, as the JAX package runs it off the TPU; it compiles for
some 15 s on a CPU, so it runs at one cell size, 30 bytes (the `10*` marker
ends the only felt).  Every size is held against the oracle's
hash_cell_bytes: 30, 31 (the marker opens a second felt, and the felt
padding takes a 0 filler), 61 and 62; the main path's 2048 is in
tests/test_torch_cell_hash_tree.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models import hashing as JH
from codex_storage_proofs_circuits_tpu.ops import encode as JE
from codex_storage_proofs_circuits_tpu.oracle.slot import hash_cell_bytes
from codex_storage_proofs_circuits_tpu_torch.fields import bn254 as F
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_cuda as TC
from codex_storage_proofs_circuits_tpu_torch.ops import poseidon2_plain as TP


def _cells(cell_size: int, n: int = 4) -> np.ndarray:
    cells = np.random.default_rng(cell_size).integers(0, 256, (n, cell_size), dtype=np.uint8)
    cells[0] = 0xFF  # every byte of every felt set
    return cells


def test_sponge2_rows_matches_jax_hash_cells_mont():
    cells = _cells(30)
    want = np.asarray(JH.hash_cells_mont(JE.encode_cells_device(jnp.asarray(cells))))
    rows = torch.from_numpy(cells.T.copy())
    got = TP.sponge2_rows(rows)
    assert got.dtype == torch.int32 and got.shape == (16, 4)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    before = dict(build.LAUNCHES)
    assert torch.equal(TC.sponge2_rows(rows), got)  # a CPU tensor: the plain version
    assert build.LAUNCHES == before


@pytest.mark.parametrize("cell_size", [30, 31, 61, 62])
def test_sponge2_rows_matches_the_oracle(cell_size):
    cells = _cells(cell_size)
    got = TP.sponge2_rows(torch.from_numpy(cells.T.copy()))
    assert [F.from_mont(v) for v in TL.unpack(got)] == [hash_cell_bytes(c.tobytes()) for c in cells]
    # the (B, cell_size).T view of the cells gives the same hashes
    assert torch.equal(TP.sponge2_rows(torch.from_numpy(cells).T), got)
