"""Slot-tree construction on the device and Merkle paths from stored layers.

Port of codex_storage_proofs_circuits_tpu/models/slot_tree.py, the analogue
of buildSlotTreeFull (gen_input/bn254.nim:21-30): bytes -> 31-byte LE felts
-> rate-2 cell hashes -> depth-b block mini-trees -> slot tree.  Trees are
built once and their layers kept for path extraction.  Several slots of
identical shape batch together on the batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import data as D
from ..oracle.merkle import MerkleProof
from ..oracle.poseidon2 import keyed_compression
from ..oracle.slot import SlotConfig

from ..ops import limbs as L
from . import hashing as H


@dataclass
class DeviceSlotTree:
    """Flat layer stack of one slot's cell -> block -> slot tree.

    layers[d] is a (width,) numpy object array of canonical felts (python
    ints); layers[0] are the cell hashes, layers[block_tree_depth] the block
    roots, layers[-1] the slot root (singleton).
    """

    layers: list[np.ndarray]
    block_tree_depth: int

    @property
    def root(self) -> int:
        assert len(self.layers[-1]) == 1
        return int(self.layers[-1][0])

    @property
    def depth(self) -> int:
        return len(self.layers) - 1

    @property
    def num_leaves(self) -> int:
        return len(self.layers[0])


def build_slot_trees(cfgs: list[SlotConfig], device) -> list[DeviceSlotTree]:
    """Build the trees of several identically shaped slots in one device batch."""
    if not cfgs:
        raise ValueError("build_slot_trees: no slots")
    cfg0 = cfgs[0]
    shape0 = (cfg0.cell_size, cfg0.block_size, cfg0.n_cells)
    if any((c.cell_size, c.block_size, c.n_cells) != shape0 for c in cfgs):
        raise ValueError("build_slot_trees: slots must be identically shaped")
    btd = cfg0.cells_per_block.bit_length() - 1

    n_slots = len(cfgs)
    cells = np.concatenate([D.load_slot_cells(c) for c in cfgs], axis=0)
    rows = torch.from_numpy(cells).to(device).T  # (cell_size, S * n_cells), read in place
    layers = H.slot_tree_from_rows(rows, btd, n_groups=n_slots)

    per_slot: list[list[np.ndarray]] = [[] for _ in range(n_slots)]
    for lyr in layers:
        ints = np.array(L.unpack(lyr), dtype=object)
        w = len(ints) // n_slots
        for s in range(n_slots):
            per_slot[s].append(ints[s * w : (s + 1) * w])
    trees = []
    for s, slot_layers in enumerate(per_slot):
        if len(slot_layers[-1]) != 1:
            raise AssertionError("slot tree did not reduce to a root")
        if cfg0.n_cells == cfgs[s].cells_per_block:
            # single-block slot: the big tree over one block root is a
            # singleton bottom layer -> one bottom-odd compression
            # (oracle/merkle.py merkle_tree; Merkle.hs:71-74)
            root = keyed_compression(3, int(slot_layers[-1][0]), 0)
            slot_layers = slot_layers + [np.array([root], dtype=object)]
        trees.append(DeviceSlotTree(slot_layers, btd))
    return trees


def extract_cell_proof(tree: DeviceSlotTree, cell_idx: int) -> MerkleProof:
    """Merged block+slot Merkle path for one cell, from the stored layers.

    Same result as oracle.slot.extract_cell_proof (Slot.hs:181-187): all
    layer widths are powers of two, so the sibling of node j at depth d is
    node j^1 of layer d.
    """
    n = tree.num_leaves
    if not 0 <= cell_idx < n:
        raise IndexError(f"cell index {cell_idx} not in [0, {n})")
    if n == 1:
        # singleton bottom: the only path entry is the zero sibling of the
        # bottom-odd compression
        return MerkleProof(0, int(tree.layers[0][0]), [0], 1)
    path = []
    j = cell_idx
    for d in range(tree.depth):
        lyr = tree.layers[d]
        # a single-block slot's appended odd compression has a zero sibling
        path.append(0 if len(lyr) == 1 else int(lyr[j ^ 1]))
        j >>= 1
    return MerkleProof(cell_idx, int(tree.layers[0][cell_idx]), path, n)
