"""Proof-input generation on the device.

Port of codex_storage_proofs_circuits_tpu/models/proof_input.py.  Same
contract as oracle.sampling.generate_proof_input (gen_input/bn254.nim:35-74,
Sampling.hs:62-89), with the hot work, cell hashing and tree construction
for every slot, on the device: in one batch for small slots
(hashing.batched_slot_layers), one streaming chunked build a slot for
large ones (models/streaming.py).  Both give the sampled slot's flat layer
stack to one tail:

  * the dataset tree over the slot roots and the slot's proof are a few
    compressions and stay on the host;
  * sampling runs on the device from the stack's root (hashing.sample_indices,
    shared with the sharded proof input), and the indices come back in
    one copy;
  * the sampled cells' bytes come from one models/data.load_cells call;
  * the sampled paths are one gather from the stack on the device, brought
    to the host in one copy (hashing.paths_to_host).
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
from ..oracle.sampling import ProofInput
from ..oracle.slot import cell_data_to_field_elements

from ..ops import limbs as L
from . import hashing as H
from .streaming import DEFAULT_CHUNK_CELLS, streaming_slot_layers


def sample_cell_indices(entropy: int, root: torch.Tensor, n_cells: int,
                        n_samples: int) -> list[int]:
    """The sampled cells of a slot (counters 1..n_samples), sampled on the
    device of root, its (NL, 1) canonical root, and brought to the host."""
    return H.sample_indices(entropy, root, n_samples, (n_cells - 1).bit_length()).tolist()


def _proof_input(glob, dset, slot_index, entropy, roots, stack) -> ProofInput:
    """The tail: the dataset tree, sampling, the cells and the paths.
    roots: every slot's root (felts); stack: the sampled slot's layers."""
    dset_tree = merkle_tree(roots)
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)
    idxs = sample_cell_indices(entropy, stack[-1], dset.n_cells, dset.n_samples)
    cells = D.load_cells(slot_cfg_from_dataset_cfg(glob, dset, slot_index), np.asarray(idxs))
    paths = H.extract_paths_device(stack, torch.tensor(idxs, dtype=torch.int64), glob.max_depth)
    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=roots[slot_index],
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=[cell_data_to_field_elements(c.tobytes()) for c in cells],
        merkle_paths=H.paths_to_host(paths),
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
    stacks = H.batched_slot_layers(slot_cfgs, device)
    roots = L.unpack(torch.cat([st[-1] for st in stacks], dim=1))
    return _proof_input(glob, dset, slot_index, entropy, roots, stacks[slot_index])


def generate_proof_input_streaming(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    device="cuda",
) -> ProofInput:
    """Large-slot path: one streaming chunked build per slot
    (models/streaming.py).  Slots other than the sampled one keep only
    their root; the sampled slot keeps its layer stack (about 2 x 64 B x
    n_cells)."""
    roots: list[int] = []
    stack = None
    for i in range(dset.n_slots):
        layers = streaming_slot_layers(slot_cfg_from_dataset_cfg(glob, dset, i), chunk_cells,
                                       device=device)
        roots.append(L.unpack(layers[-1])[0])
        if i == slot_index:
            stack = layers
    return _proof_input(glob, dset, slot_index, entropy, roots, stack)
