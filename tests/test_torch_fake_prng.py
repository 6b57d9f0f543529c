"""Port fake-data PRNG (plain torch and the K3 wrapper) and byte encoding
against the JAX package, models.data and the oracle, bit-exact.

The JAX side is its portable scan path `_gen_scan`, which
tests/test_prng_kernel.py holds equal to the Pallas kernel `_gen_pallas`.
The kernel against the plain version: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models.data import gen_fake_cells
from codex_storage_proofs_circuits_tpu.ops import encode as JE
from codex_storage_proofs_circuits_tpu.ops import fake_prng as JF
from codex_storage_proofs_circuits_tpu.oracle.slot import gen_fake_cell
from codex_storage_proofs_circuits_tpu_torch.kernels import build
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE
from codex_storage_proofs_circuits_tpu_torch.ops import fake_prng as TF

N_STEPS, B = 8, 2048


def test_seed_bases_and_planes_match_jax():
    seed, start = 12345, (1 << 64) - 5  # the cell index wraps in 64 bits
    s1, s2 = TF.fake_seed_bases(seed, start)
    j1, j2 = JF.fake_seed_bases(seed, start)
    assert np.array_equal(s1.numpy(), np.asarray(j1).astype(np.int32))
    assert np.array_equal(s2.numpy(), np.asarray(j2).astype(np.int32))
    p1, p2 = TF.seed_planes(s1, s2, 70000)  # crosses a 16-bit limb of the index
    q1, q2 = JF.seed_planes_device(j1, j2, 70000)
    assert np.array_equal(p1.numpy(), np.asarray(q1).astype(np.int32))
    assert np.array_equal(p2.numpy(), np.asarray(q2).astype(np.int32))


def test_plain_rows_match_jax_scan():
    s1, s2 = TF.seed_planes(*TF.fake_seed_bases(12345, 7), B)
    got = TF.gen_rows_plain(s1, s2, N_STEPS)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (N_STEPS, B)
    j1, j2 = JF.fake_seed_planes(12345, 7, B)
    want = np.asarray(JF._gen_scan(j1, j2, N_STEPS))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [12345, (1 << 64) - 3])  # seed1 wraps in 64 bits
def test_rows_match_models_data_and_oracle(seed):
    rows = TF.gen_rows(*TF.fake_seed_bases(seed, 3), 16, 5)  # CPU: plain version
    cells = rows.T.numpy()
    assert np.array_equal(cells, gen_fake_cells(16, seed, np.arange(3, 8)))
    for i in range(5):
        assert cells[i].tobytes() == gen_fake_cell(16, seed, 3 + i)


def test_gen_rows_on_cpu_launches_nothing():
    before = dict(build.LAUNCHES)
    s1, s2 = TF.fake_seed_bases(5, 0)
    assert torch.equal(TF.gen_rows(s1, s2, 12, 33), TF.gen_rows_plain(*TF.seed_planes(s1, s2, 33), 12))
    assert build.LAUNCHES == before


@pytest.mark.parametrize("cell_size", [62, 64, 93])  # 93 = 3 * 31: a full marker chunk
def test_encode_matches_jax(cell_size):
    rng = np.random.default_rng(cell_size)
    cells = rng.integers(0, 256, size=(12, cell_size), dtype=np.uint8)
    t = torch.from_numpy(cells)
    assert TE.n_chunks(cell_size) == JE.n_chunks(cell_size)
    padded = TE.pad_bytes(t)
    assert np.array_equal(padded.numpy(), JE.pad_bytes_np(cells))
    want = np.asarray(JE.encode_cells(cells)).astype(np.int32)
    assert np.array_equal(TE.encode_cells(t).numpy(), want)
    assert np.array_equal(TE.encode_rows(t.T.contiguous()).numpy(), want)
    felts = np.asarray(JE.bytes_to_felt_limbs(jnp.asarray(padded.numpy())))
    assert np.array_equal(TE.bytes_to_felt_limbs(padded).numpy(), felts.astype(np.int32))
