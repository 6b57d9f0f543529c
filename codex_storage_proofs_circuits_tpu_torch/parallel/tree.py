"""Sharded Merkle tree builds over a device mesh.

Port of codex_storage_proofs_circuits_tpu/parallel/tree.py, where
shard_map and XLA collectives do the sharding.  Here each shard is a loop
step on its own device:

  * the cells of a slot split over the "cells" axis of its mesh row; each
    shard hashes its lane range and reduces its subtree to one node, with
    the single-device functions (keys by absolute depth, so a subtree's
    layers are exact segments of the slot's);
  * the frontier (one node a shard) is gathered onto the row's device and
    the top layers are computed there: in one process once, since nothing
    reads a second copy; with the row spread over processes, in each of
    them after an all_reduce (parallel/distributed.py);
  * slots split over the "slots" axis; their roots gather once for the
    small odd-width dataset tree, which every process computes.

Two routes feed the shards.  The felts route takes encoded cells, the
JAX package's API (kernel K2's and K6's limb-plane entries on the card,
then K1, or K4 / K5).  The byte-row route makes each shard's own cell
range: fake data by the PRNG (K3) from the seed bases of its first cell,
file data through models/data.load_cells for its range, and hashes the
rows with the byte-row entries of the single-device path (K2, K6), in
chunks of at most DEFAULT_CHUNK_CELLS: no slot's felts cross from the host,
which at 1 GB a slot would be about 2.2 GB.

Layers are canonical limb planes: (16, w) for BN254, (4, 4, w) for
Goldilocks.  A build returns, for each slot s its process holds,
locs[d][s] (one tensor a cells shard, on the shard's device; join()
concatenates them into the global layer d), tops[d][s] (the frontier and
the layers above it, on the row's device) and the dataset layers; entries
of slots it does not hold, and of padding slots (s >= n_slots), are None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models import hashing as H
from ..models.streaming import DEFAULT_CHUNK_CELLS, bn254_rows_tree, bn254_tops, stream_range
from ..ops import limbs as L
from .distributed import sum_over_processes
from .mesh import Mesh, cells_axis, slots_axis

NL = L.NL


@dataclass(frozen=True)
class FieldOps:
    """A field's tree functions, all canonical in and out.  node: the shape
    of a node's limb planes (a layer is node + (w,)); felts_tree(felts,
    btd): the layers of one power-of-two subtree, its root last;
    rows_tree(rows, btd): a chunk's layers for models/streaming.stream_range;
    tops(roots, btd, depth): the layers above a row of subtree roots at that
    depth; general(leaves): the odd-width tree of the oracle's merkle_tree
    (the dataset tree, and the root of a single-block slot)."""

    node: tuple[int, ...]
    felts_tree: Callable
    rows_tree: Callable
    tops: Callable
    general: Callable


def _bn254_general(roots: torch.Tensor) -> list[torch.Tensor]:
    return H.from_mont_layers(H.tree_reduce_general(L.to_mont(roots)))


BN254 = FieldOps((NL,), H.slot_tree_from_felts, bn254_rows_tree, bn254_tops, _bn254_general)


def join(shards: list[torch.Tensor]) -> torch.Tensor:
    """One layer's shards (cells order) -> the global layer, on the first
    shard's device."""
    if any(s is None for s in shards):
        raise ValueError("join: a shard of this layer lives in another process")
    return torch.cat([s.to(shards[0].device) for s in shards], dim=-1)


def padded_slot_count(n_slots: int, mesh: Mesh) -> int:
    """n_slots rounded up to a multiple of the mesh's slots axis."""
    n_rows = mesh.shape[slots_axis]
    return -(-n_slots // n_rows) * n_rows


def _log2(x: int, what: str) -> int:
    if x < 1 or x & (x - 1):
        raise ValueError(f"{what} {x} is not a power of two")
    return x.bit_length() - 1


def _row_spans_processes(mesh: Mesh) -> bool:
    return mesh.ranks is not None and any(len(set(row)) > 1 for row in mesh.ranks)


def build_dataset(ops: FieldOps, shard_layers, n_cells: int, n_slots_padded: int,
                  mesh: Mesh, btd: int, n_slots: int):
    """The sharded build core.  shard_layers(s, lo, w, device): the canonical
    layers of cells lo..lo+w-1 of slot s on device, the subtree root last.
    Returns (locs, tops, dataset_layers) as the module docstring says."""
    n_rows, n_cs = mesh.shape[slots_axis], mesh.shape[cells_axis]
    if n_slots_padded % n_rows:
        raise ValueError(f"{n_slots_padded} slots do not split over {n_rows} mesh rows")
    if not 1 <= n_slots <= n_slots_padded:
        raise ValueError(f"n_slots {n_slots} not in 1..{n_slots_padded}")
    _log2(n_cs, "cells shards")
    if n_cells % n_cs:
        raise ValueError(f"{n_cells} cells do not split over {n_cs} shards")
    w = n_cells // n_cs
    n_local = _log2(w, "cells a shard")
    n_top = n_cs.bit_length() - 1
    per = n_slots_padded // n_rows
    # a single-block slot: the oracle's tree over its one block root is a
    # singleton bottom, which still gets one bottom-odd compression (key 3
    # against zero, oracle/merkle.py merkle_tree), as
    # models/hashing.batched_slot_layers gives it on one device
    single_block = n_cells == 1 << btd

    locs = [[None] * n_slots_padded for _ in range(n_local)]
    tops = [[None] * n_slots_padded for _ in range(n_top + 1 + single_block)]
    nodes: dict[tuple[int, int], torch.Tensor] = {}
    for s in range(n_slots):
        g = s // per
        if not mesh.local_row(g):
            continue
        shards = [None] * n_cs
        for c in range(n_cs):
            if mesh.is_local(g, c):
                shards[c] = shard_layers(s, c * w, w, mesh.devices[g][c])
                nodes[s, c] = shards[c][-1]
        for d in range(n_local):
            locs[d][s] = [None if lay is None else lay[d] for lay in shards]

    def row_frontier(s: int, got) -> torch.Tensor:
        dev = mesh.row_device(s // per)
        return torch.cat([got(c).to(dev) for c in range(n_cs)], dim=-1)

    if _row_spans_processes(mesh):
        # one all_reduce for every slot's frontier: each process fills in
        # the nodes of its own shards
        buf = torch.zeros((n_slots, n_cs) + ops.node + (1,), dtype=torch.int32,
                          device=mesh.row_device(_first_local_row(mesh)))
        for (s, c), v in nodes.items():
            buf[s, c] = v.to(buf.device)
        buf = sum_over_processes(buf)
        frontiers = {s: row_frontier(s, lambda c, s=s: buf[s, c])
                     for s in range(n_slots) if mesh.local_row(s // per)}
    else:
        frontiers = {s: row_frontier(s, lambda c, s=s: nodes[s, c])
                     for s in range(n_slots) if mesh.local_row(s // per)}
    for s, front in frontiers.items():
        layers = [front, *ops.tops(front, btd, n_local)]
        if single_block:
            layers.append(ops.general(layers[-1])[-1])
        for d, lyr in enumerate(layers):
            tops[d][s] = lyr

    # the slot roots, gathered for the dataset tree
    dev = mesh.row_device(_first_local_row(mesh))
    if mesh.multiprocess:
        buf = torch.zeros((n_slots,) + ops.node + (1,), dtype=torch.int32, device=dev)
        for s in frontiers:
            if mesh.row_leader(s // per):
                buf[s] = tops[-1][s].to(dev)
        roots = torch.cat(list(sum_over_processes(buf)), dim=-1)
    else:
        roots = torch.cat([tops[-1][s].to(dev) for s in range(n_slots)], dim=-1)
    return locs, tops, ops.general(roots)


def _first_local_row(mesh: Mesh) -> int:
    return next(g for g in range(mesh.shape[slots_axis]) if mesh.local_row(g))


def felts_shards(felts_all, ops: FieldOps, btd: int):
    """shard_layers of the felts route: (n_slots_padded, nfelts, ..., n_cells)
    encoded cells (or a distributed.LocalSlots), cut per shard."""

    def shard_layers(s, lo, w, device):
        return ops.felts_tree(felts_all[s][..., lo : lo + w].to(device), btd)

    return shard_layers


def rows_shards(cfgs, ops: FieldOps):
    """shard_layers of the byte-row route: each shard makes its own cells'
    byte rows and hashes them in chunks of at most DEFAULT_CHUNK_CELLS
    (models/streaming.stream_range over its cell range)."""

    def shard_layers(s, lo, w, device):
        return stream_range(cfgs[s], lo, w, DEFAULT_CHUNK_CELLS, None, device, ops.rows_tree,
                            ops.tops)

    return shard_layers


def felts_n_cells(felts_all, mesh: Mesh) -> int:
    """The cells a slot of the felts route, from a slot this process holds."""
    per = len(felts_all) // mesh.shape[slots_axis]
    return felts_all[_first_local_row(mesh) * per].shape[-1]


def sharded_slot_tree_layers(felts: torch.Tensor, mesh: Mesh, block_tree_depth: int):
    """One slot's tree, its cells sharded over the mesh's "cells" axis (the
    first row builds it: JAX replicates a single slot over the slots axis).

    felts: (nfelts, NL, n_cells) canonical encoded cells, n_cells a power
    of two divisible by the cells-axis size.  Returns (local_layers,
    top_layers): local_layers[d] the shards of the global layer d
    (join() concatenates them); top_layers from the gathered frontier (at
    depth log2(n_cells / n_shards)) up to the root.
    """
    row = Mesh(mesh.devices[:1], None if mesh.ranks is None else mesh.ranks[:1], mesh.rank)
    locs, tops, _ = build_dataset(BN254, felts_shards([felts], BN254, block_tree_depth),
                                  felts.shape[-1], 1, row, block_tree_depth, 1)
    return [lyr[0] for lyr in locs], [lyr[0] for lyr in tops]


def sharded_dataset_build(felts_all, mesh: Mesh, block_tree_depth: int,
                          n_slots: int | None = None):
    """Full BN254 dataset build: slots sharded on "slots", cells on "cells".

    felts_all: (n_slots_padded, nfelts, NL, n_cells) canonical encoded
    cells, n_slots_padded a multiple of the slots-axis size (padding slots
    are not built: the dataset tree uses the first `n_slots` roots), or a
    distributed.LocalSlots in a multi-process run.  Returns (locs, tops,
    dataset_layers)."""
    n_pad = len(felts_all)
    return build_dataset(BN254, felts_shards(felts_all, BN254, block_tree_depth),
                         felts_n_cells(felts_all, mesh), n_pad, mesh, block_tree_depth,
                         n_pad if n_slots is None else n_slots)


def sharded_dataset_build_rows(cfgs, mesh: Mesh, block_tree_depth: int):
    """The byte-row route of sharded_dataset_build: cfgs are the n_slots
    slots' SlotConfigs (same shape), padded to padded_slot_count slots over
    the rows; each shard makes and hashes its own cells."""
    return build_dataset(BN254, rows_shards(cfgs, BN254), cfgs[0].n_cells,
                         padded_slot_count(len(cfgs), mesh), mesh, block_tree_depth, len(cfgs))
