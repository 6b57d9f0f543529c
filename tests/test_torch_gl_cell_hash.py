"""The port's Goldilocks cell digest from byte rows (ops/goldilocks_plain.py::
sponge_digest_rows, the plain version of kernel K6's byte-row entry, and the
wrapper ops/goldilocks_cuda.py::sponge_digest_rows, which takes it for CPU
tensors) against the JAX package and the oracle, for both hashes.

Bit-exact; cell bytes are made with numpy from a seed.  The JAX side is
ops/goldilocks_jnp.py::sponge_digest_felts on ops/gl_encode.py::
encode_cells_gl_device of the same bytes (each eager jnp sponge compiles its
permutation scan anew, some 10 s for Poseidon2-GL on a CPU), at one small
cell size.  Every size is held against the oracle's digest_bytes
(bytes_to_felts_gl, then the sponge): 30 (less than a chunk), 31, 61 (the
`10*` marker ends the first 62-byte chunk), 62 (the marker opens a second
chunk) and the main path's 2048.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.ops import gl_encode as JGE
from codex_storage_proofs_circuits_tpu.ops import goldilocks_jnp as GJ
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.ops import gl_encode as TGE
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_cuda as TGC
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TG

HASHES = ("poseidon2", "monolith")


def _cells(cell_size: int, n: int = 3) -> np.ndarray:
    cells = np.random.default_rng(cell_size).integers(0, 256, (n, cell_size), dtype=np.uint8)
    cells[0] = 0xFF  # every bit of every felt set
    return cells


@pytest.mark.parametrize("hash_fun", HASHES)
def test_sponge_digest_rows_matches_jnp(hash_fun):
    cells = _cells(30)
    felts = JGE.encode_cells_gl_device(jnp.asarray(cells.T), 30)
    want = np.asarray(GJ.sponge_digest_felts(hash_fun, felts))
    rows = torch.from_numpy(cells.T.copy())
    got = TG.sponge_digest_rows(hash_fun, rows)
    assert got.dtype == torch.int32 and got.shape == (4, 4, 3)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    before = dict(build.LAUNCHES)
    assert torch.equal(TGC.sponge_digest_rows(rows, hash_fun), got)  # CPU: the plain version
    assert torch.equal(TGH.sponge_digests_rows(hash_fun, rows), got)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("cell_size", [30, 31, 61, 62, 2048])
@pytest.mark.parametrize("hash_fun", HASHES)
def test_sponge_digest_rows_matches_the_oracle(hash_fun, cell_size):
    cells = _cells(cell_size)
    got = TG.sponge_digest_rows(hash_fun, torch.from_numpy(cells).T)  # a (B, cell).T view
    assert TGH.digests(got) == [OG.digest_bytes(hash_fun, c.tobytes()) for c in cells]
    if cell_size < 2048:  # the felt path it replaces
        felts = TGE.encode_cells(torch.from_numpy(cells))
        assert torch.equal(TG.sponge_digest_felts(hash_fun, felts), got)
