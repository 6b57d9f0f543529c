"""Sampling + proof-input generation (L4).

Semantics follow reference/haskell/src/Sampling.hs and
reference/nim/proof_input/src/{sample,gen_input}/bn254.nim.  Unlike the Nim
generator, slot trees are built once and their layers reused for every sample
(the Nim code rebuilds the full slot tree inside the per-sample loop,
gen_input/bn254.nim:57 — a quadratic waste this implementation avoids).
"""

from __future__ import annotations

from dataclasses import dataclass

from .poseidon2 import sponge2
from .merkle import MerkleProof, merkle_tree, extract_proof
from .slot import (
    SlotConfig,
    calc_slot_tree,
    load_cell,
    cell_data_to_field_elements,
    extract_cell_proof,
)
from .dataset import GlobalConfig, DataSetConfig, slot_cfg_from_dataset_cfg

Felt = int


def sample_cell_index(entropy: Felt, slot_root: Felt, n_cells: int, counter: int) -> int:
    """idx = sponge2([entropy, slotRoot, counter]) mod nCells, nCells a power
    of two (sample/bn254.nim:16-24, Sampling.hs:31-35)."""
    assert n_cells & (n_cells - 1) == 0, "nCells must be a power of two"
    h = sponge2([entropy, slot_root, counter])
    return h & (n_cells - 1)


def sample_cell_indices(entropy: Felt, slot_root: Felt, n_cells: int, n_samples: int) -> list[int]:
    """Counters run 1..nSamples (sample/bn254.nim:26-27, Sampling.hs:75)."""
    return [
        sample_cell_index(entropy, slot_root, n_cells, i)
        for i in range(1, n_samples + 1)
    ]


@dataclass
class ProofInput:
    """The circuit input bundle (types.nim:52-60, Sampling.hs:48-59).

    slot_proof is padded to max_log2_n_slots, merkle_paths to max_depth.
    """

    entropy: Felt
    data_set_root: Felt
    slot_index: int
    slot_root: Felt
    n_slots_per_dataset: int
    n_cells_per_slot: int
    slot_proof: list[Felt]
    cell_data: list[list[Felt]]  # nSamples x nFieldElemsPerCell
    merkle_paths: list[list[Felt]]  # nSamples x maxDepth


def generate_proof_input(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Felt,
) -> ProofInput:
    """Full pipeline: all slot trees -> dataset tree -> sample -> witnesses
    (gen_input/bn254.nim:35-74, Sampling.hs:62-89)."""
    slot_cfgs = [
        slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)
    ]
    slot_trees = [calc_slot_tree(c) for c in slot_cfgs]
    slot_roots = [t.root for t in slot_trees]

    dset_tree = merkle_tree(slot_roots)
    dset_root = dset_tree.root
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    our_cfg = slot_cfgs[slot_index]
    our_tree = slot_trees[slot_index]
    our_root = slot_roots[slot_index]

    idxs = sample_cell_indices(entropy, our_root, dset.n_cells, dset.n_samples)

    cell_data = [
        cell_data_to_field_elements(load_cell(our_cfg, i)) for i in idxs
    ]
    merkle_paths = [
        extract_cell_proof(our_cfg, our_tree, i).padded(glob.max_depth).merkle_path
        for i in idxs
    ]

    return ProofInput(
        entropy=entropy,
        data_set_root=dset_root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )
