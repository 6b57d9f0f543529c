"""The port's sharded BN254 proof input (parallel/proof_input.py) and a
dataset build over a 1 x 8 row, on CPU meshes, against the JAX package's
oracle, bit-exact: sampling from the slot root on the (CPU) device, path gathers
from the sharded layers, the cells reread on the host."""

from dataclasses import asdict

import torch

from codex_storage_proofs_circuits_tpu.oracle import dataset as JD
from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.models.circuit import check_circuit_semantics
from codex_storage_proofs_circuits_tpu_torch.models.witness import evaluate_witness, generate_witness
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource

GLOB = GlobalConfig(max_depth=8, max_log2_n_slots=5, cell_size=16, block_size=32)
DSET = DataSetConfig(n_slots=3, n_cells=8, n_samples=4, data_src=DataSource("fake", seed=12345))
JGLOB = JD.GlobalConfig(max_depth=8, max_log2_n_slots=5, cell_size=16, block_size=32)
JDSET = JD.DataSetConfig(n_slots=3, n_cells=8, n_samples=4,
                         data_src=JS.DataSource("fake", seed=12345))


def test_dataset_build_1x8_matches_oracle():
    cfgs = [slot_cfg_from_dataset_cfg(GLOB, DSET, i) for i in range(DSET.n_slots)]
    felts = torch.stack([TE.encode_cells(torch.from_numpy(D.load_slot_cells(c))) for c in cfgs])
    mesh = P.make_mesh(n_cells_shards=8, devices=["cpu"] * 8)
    locs, tops, dlayers = P.sharded_dataset_build(felts, mesh, GLOB.block_tree_depth)
    assert locs == []  # one cell a shard
    roots = [JS.calc_slot_tree(JD.slot_cfg_from_dataset_cfg(JGLOB, JDSET, i)).root
             for i in range(DSET.n_slots)]
    assert [TL.unpack(tops[-1][s])[0] for s in range(DSET.n_slots)] == roots
    assert [TL.unpack(lyr) for lyr in dlayers] == merkle_tree(roots).layers


def test_sharded_proof_input_2x4_matches_oracle():
    mesh = P.make_mesh(n_cells_shards=4, n_slot_shards=2, devices=["cpu"] * 8)
    pi = P.sharded_proof_input(GLOB, DSET, 2, 0xDEADBEEF, mesh)
    assert asdict(pi) == asdict(generate_proof_input(JGLOB, JDSET, 2, 0xDEADBEEF))
    check_circuit_semantics(GLOB, DSET, pi)
    evaluate_witness(GLOB, pi, generate_witness(GLOB, pi))
