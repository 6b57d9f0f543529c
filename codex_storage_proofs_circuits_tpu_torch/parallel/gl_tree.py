"""Sharded Goldilocks Merkle tree builds over a device mesh.

Port of codex_storage_proofs_circuits_tpu/parallel/gl_tree.py, the GL twin
of parallel/tree.py: the same shards, frontier gather, top layers and
dataset tree, over (4, 4, w) digest layers with either hash (K6, then K4
for Poseidon2-GL or K5 for Monolith, on the card).  The single-device
reducers of the JAX module, gl_tree_reduce_layers and
gl_tree_reduce_general, live in models/gl_hashing.py.
"""

from __future__ import annotations

from ..models import gl_hashing as GH
from ..models.streaming import gl_rows_tree, gl_tops
from ..ops.goldilocks_plain import HASHES
from .mesh import Mesh
from .tree import (FieldOps, build_dataset, felts_n_cells, felts_shards, padded_slot_count,
                   rows_shards)


def gl_ops(hash_fun: str) -> FieldOps:
    """The Goldilocks tree functions of one hash."""
    if hash_fun not in HASHES:
        raise ValueError(f"unknown hash {hash_fun!r}: expected one of {HASHES}")

    def felts_tree(felts, btd):
        return GH.slot_tree_from_felts_gl(hash_fun, felts, btd)

    def general(roots):
        return GH.gl_tree_reduce_general(roots, hash_fun)

    return FieldOps((GH.FELTS_PER_DIGEST, GH.NL), felts_tree, gl_rows_tree(hash_fun),
                    gl_tops(hash_fun), general)


def sharded_gl_dataset_build(felts_all, mesh: Mesh, hash_fun: str = "poseidon2",
                             block_tree_depth: int = 5, n_slots: int | None = None):
    """Full GL dataset build: slots sharded on "slots", cells on "cells".

    felts_all: (n_slots_padded, nfelts, 4, n_cells) encoded cells (62-byte
    chunk encoding, models/gl_hashing.encode_cells_gl), n_slots_padded a
    multiple of the slots-axis size, or a distributed.LocalSlots.  Returns
    (locs, tops, dataset_layers) as parallel/tree.py says."""
    ops = gl_ops(hash_fun)
    n_pad = len(felts_all)
    return build_dataset(ops, felts_shards(felts_all, ops, block_tree_depth),
                         felts_n_cells(felts_all, mesh), n_pad, mesh, block_tree_depth,
                         n_pad if n_slots is None else n_slots)


def sharded_gl_dataset_build_rows(cfgs, mesh: Mesh, hash_fun: str = "poseidon2",
                                  block_tree_depth: int = 5):
    """The byte-row route of sharded_gl_dataset_build (see
    parallel/tree.sharded_dataset_build_rows)."""
    ops = gl_ops(hash_fun)
    return build_dataset(ops, rows_shards(cfgs, ops), cfgs[0].n_cells,
                         padded_slot_count(len(cfgs), mesh), mesh, block_tree_depth, len(cfgs))
