"""Proof-input generation on the device.

Port of codex_storage_proofs_circuits_tpu/models/proof_input.py.  Same
contract as oracle.sampling.generate_proof_input (gen_input/bn254.nim:35-74,
Sampling.hs:62-89), with the hot work, cell hashing and tree construction
for every slot, batched on the device.  The dataset tree over the slot
roots, the sampling hashes (nSamples sponges of 3 felts) and the sampled
cells' bytes are negligible and stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import data as D
from ..oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from ..oracle.merkle import extract_proof, merkle_tree
from ..oracle.sampling import ProofInput, sample_cell_indices
from ..oracle.slot import cell_data_to_field_elements

from ..ops import limbs as L
from . import hashing as H
from .slot_tree import build_slot_trees, extract_cell_proof
from .streaming import DEFAULT_CHUNK_CELLS, streaming_slot_layers


def _proof_input(glob, dset, slot_index, entropy, roots, our_cfg, merkle_paths_of):
    """The shared tail: dataset tree, sampling, cell data, paths."""
    dset_tree = merkle_tree(roots)
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)
    our_root = roots[slot_index]
    idxs = sample_cell_indices(entropy, our_root, dset.n_cells, dset.n_samples)
    cells = D.load_cells(our_cfg, np.asarray(idxs))
    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=[cell_data_to_field_elements(c.tobytes()) for c in cells],
        merkle_paths=merkle_paths_of(idxs),
    )


def generate_proof_input(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
    device="cuda",
) -> ProofInput:
    """All slots' trees in one batched device build (every cell of every
    slot is loaded on the host first: for small slots)."""
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    trees = build_slot_trees(slot_cfgs, device)
    our_tree = trees[slot_index]
    return _proof_input(
        glob, dset, slot_index, entropy, [t.root for t in trees], slot_cfgs[slot_index],
        lambda idxs: [
            extract_cell_proof(our_tree, i).padded(glob.max_depth).merkle_path for i in idxs
        ],
    )


def generate_proof_input_streaming(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    device="cuda",
) -> ProofInput:
    """Large-slot path: one streaming chunked build per slot
    (models/streaming.py) and one batched gather of the sampled paths on
    the device.  Slots other than the sampled one keep only their root; the
    sampled slot keeps its layer stack (about 2 x 64 B x n_cells)."""
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    roots: list[int] = []
    our_layers = None
    for i, cfg in enumerate(slot_cfgs):
        layers = streaming_slot_layers(cfg, chunk_cells, device=device)
        roots.append(L.unpack(layers[-1])[0])
        if i == slot_index:
            our_layers = layers

    def merkle_paths_of(idxs):
        paths = H.extract_paths_device(
            our_layers, torch.tensor(idxs, dtype=torch.int64), glob.max_depth
        )  # (max_depth, NL, S)
        paths = paths.cpu()
        return [L.unpack(paths[:, :, k].T) for k in range(len(idxs))]

    return _proof_input(
        glob, dset, slot_index, entropy, roots, slot_cfgs[slot_index], merkle_paths_of
    )
