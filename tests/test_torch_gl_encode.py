"""The port's Goldilocks cell encode (ops/gl_encode.py, and
models/gl_hashing.encode_cells_gl on top of it) against the JAX package's
device encode (ops/gl_encode.encode_cells_gl_device), its host encode
(models/gl_hashing.encode_cells_gl) and the oracle (bytes_to_felts_gl).

Bit-exact; cell bytes are made with numpy from a seed.  The cell sizes
cover a cell shorter than a chunk, exactly one chunk (the `10*` marker then
opens a second), and the 2048-byte cells of the main path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models import gl_hashing as JGH
from codex_storage_proofs_circuits_tpu.ops import gl_encode as JGE
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.ops import gl_encode as TGE
from codex_storage_proofs_circuits_tpu_torch.ops import goldilocks_plain as TG


@pytest.mark.parametrize("cell_size", [31, 62, 64, 128, 2048])
def test_encode_matches_jax_device_host_and_oracle(cell_size):
    cells = np.random.default_rng(cell_size).integers(0, 256, (6, cell_size), dtype=np.uint8)
    cells[0] = 0xFF  # every bit of every felt set
    got = TGE.encode_cells(torch.from_numpy(cells))
    assert got.dtype == torch.int32 and got.shape == (TGE.n_felts(cell_size), 4, 6)
    assert torch.equal(TGE.encode_rows(torch.from_numpy(cells.T.copy())), got)
    assert torch.equal(TGH.encode_cells_gl(cells), got)
    device = np.asarray(JGE.encode_cells_gl_device(jnp.asarray(cells.T), cell_size))
    host = np.asarray(JGH.encode_cells_gl(cells))
    assert np.array_equal(got.numpy(), device.astype(np.int32))
    assert np.array_equal(got.numpy(), host.astype(np.int32))
    for b in range(6):
        want = OG.bytes_to_felts_gl(cells[b].tobytes())
        assert [TG.unpack(got[f])[b] for f in range(got.shape[0])] == want
