"""Dataset model: many slots, per-slot derived configs, dataset tree.

Semantics follow reference/haskell/src/DataSet.hs and
reference/nim/proof_input/src/dataset.nim.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .slot import DataSource, SlotConfig

MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class GlobalConfig:
    """Circuit-shaping parameters (types.nim:87-91)."""

    max_depth: int = 32  # max depth of the slot tree (log2 of max nCells)
    max_log2_n_slots: int = 8  # log2 of max slots per dataset
    cell_size: int = 2048
    block_size: int = 65536

    @property
    def cells_per_block(self) -> int:
        q, r = divmod(self.block_size, self.cell_size)
        assert r == 0, "block size not divisible by cell size"
        return q

    @property
    def block_tree_depth(self) -> int:
        k = self.cells_per_block
        d = k.bit_length() - 1
        assert 1 << d == k, "cells per block must be a power of two"
        return d

    @property
    def n_field_elems_per_cell(self) -> int:
        return (self.cell_size + 30) // 31


@dataclass(frozen=True)
class DataSetConfig:
    """Per-dataset parameters (types.nim:81-85)."""

    n_slots: int = 11
    n_cells: int = 256  # per slot, power of two
    n_samples: int = 5
    data_src: DataSource = DataSource("fake", seed=12345)


def parametric_slot_seed(seed: int, k: int) -> int:
    """Per-slot fake-data seed: seed + 72 + 1001*k with u64 wraparound
    (dataset.nim:31-32 == DataSet.hs:84-85)."""
    return (seed + 72 + 1001 * k) & MASK64


def parametric_slot_filename(basefile: str, k: int) -> str:
    """dir/dset.dat -> dir/dset5.dat for slot 5 (DataSet.hs:88-90)."""
    stem, ext = os.path.splitext(basefile)
    return f"{stem}{k}{ext}"


def slot_data_source(src: DataSource, k: int) -> DataSource:
    if src.kind == "fake":
        return DataSource("fake", seed=parametric_slot_seed(src.seed, k))
    return DataSource("file", filename=parametric_slot_filename(src.filename, k))


def slot_cfg_from_dataset_cfg(
    glob: GlobalConfig, dset: DataSetConfig, idx: int
) -> SlotConfig:
    assert 0 <= idx < dset.n_slots
    return SlotConfig(
        cell_size=glob.cell_size,
        block_size=glob.block_size,
        n_cells=dset.n_cells,
        n_samples=dset.n_samples,
        data_src=slot_data_source(dset.data_src, idx),
    )
