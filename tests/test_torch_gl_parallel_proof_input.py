"""The port's sharded Goldilocks proof inputs (parallel/proof_input.py),
both hashes, on a 2 x 4 CPU mesh against the JAX package's GL oracle,
bit-exact: sampling by the rate-8 sponge from the slot root on the (CPU) device, path
gathers from the sharded layers, the cells reread on the host."""

from dataclasses import asdict

import pytest

from codex_storage_proofs_circuits_tpu.oracle import dataset as JD
from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import generate_proof_input_gl
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import DataSetConfig, GlobalConfig
from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import check_proof_input_gl
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource

GLOB = GlobalConfig(max_depth=8, max_log2_n_slots=5, cell_size=16, block_size=32)
DSET = DataSetConfig(n_slots=3, n_cells=8, n_samples=4, data_src=DataSource("fake", seed=12345))
JGLOB = JD.GlobalConfig(max_depth=8, max_log2_n_slots=5, cell_size=16, block_size=32)
JDSET = JD.DataSetConfig(n_slots=3, n_cells=8, n_samples=4,
                         data_src=JS.DataSource("fake", seed=12345))
ENTROPY = (0xDEADBEEF, 1, 2, 3)


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_sharded_gl_proof_input_2x4_matches_oracle(hash_fun):
    mesh = P.make_mesh(n_cells_shards=4, n_slot_shards=2, devices=["cpu"] * 8)
    pig = P.sharded_gl_proof_input(hash_fun, GLOB, DSET, 1, ENTROPY, mesh)
    assert asdict(pig) == asdict(generate_proof_input_gl(hash_fun, JGLOB, JDSET, 1, ENTROPY))
    check_proof_input_gl(hash_fun, GLOB, pig)

