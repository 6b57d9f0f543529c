"""File-backed cells (models/data.load_cells): a contiguous run of cells is
read into one block, page-locked on a machine with a CUDA device, by
positioned reads of disjoint parts on a pool of threads once it is large
enough (MIN_PART_BYTES, set to a few cells here so that small files
split); any other index list a cell at a time.  Held against an
independent np.memmap of the file and, through the streaming builds of both
fields, against the oracle's slot roots.

The file imports no jax.  The `cuda` tests skip without a card; on the
card:

    python -m pytest -q -m cuda tests/test_torch_data_file.py
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import os
import threading

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import (
    DataSource,
    SlotConfig,
    calc_slot_tree,
)

CELL = 64
N_CELLS = 32


def _slot_file(path, n_cells=N_CELLS, cell_size=CELL, extra=0, seed=9):
    data = np.random.default_rng(seed).integers(0, 256, n_cells * cell_size + extra, np.uint8)
    data.tofile(path)
    return SlotConfig(cell_size=cell_size, block_size=4 * cell_size, n_cells=n_cells,
                      n_samples=1, data_src=DataSource("file", filename=str(path)))


def _reads():
    return dict(D.FILE_READS)


@pytest.mark.parametrize(
    "idx",
    [
        list(range(0, 8)),  # a run from cell 0
        list(range(11, 20)),  # a run from the middle
        [N_CELLS - 1],  # the last cell alone
        [5],  # a single cell
        list(range(N_CELLS)),  # the whole file
        [3, 17, 0, 30, 8],  # scattered
        [9, 8, 7, 6],  # descending
        [4, 5, 5, 6],  # a repeat
    ],
    ids=["run-from-0", "run-from-middle", "last-cell", "single-cell", "whole-file",
         "scattered", "descending", "repeat"],
)
def test_load_cells_equal_a_memmap_of_the_file(tmp_path, idx):
    cfg = _slot_file(tmp_path / "slot.dat")
    want = np.memmap(cfg.data_src.filename, np.uint8, "r").reshape(N_CELLS, CELL)[idx]
    got = D.load_cells(cfg, np.asarray(idx))
    assert got.shape == (len(idx), CELL) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_read_counter_splits_bulk_and_cell_reads(tmp_path):
    cfg = _slot_file(tmp_path / "slot.dat")
    before = _reads()
    D.load_cells(cfg, np.arange(4, 20))
    assert _reads() == {"bulk": before["bulk"] + 1, "cell": before["cell"],
                        "part": before["part"] + 1}
    scattered = [1, 30, 7, 7, 2]
    D.load_cells(cfg, scattered)
    assert _reads() == {"bulk": before["bulk"] + 1, "cell": before["cell"] + len(scattered),
                        "part": before["part"] + 1}


@pytest.mark.parametrize("idx", [np.arange(N_CELLS), [0, N_CELLS - 1]], ids=["run", "cells"])
def test_a_file_one_byte_short_raises(tmp_path, idx):
    cfg = _slot_file(tmp_path / "slot.dat", extra=-1)
    with pytest.raises(EOFError, match="short read from slot file"):
        D.load_cells(cfg, idx)


@pytest.mark.parametrize("field", ["goldilocks", "bn254"])
def test_file_backed_streaming_roots_equal_the_oracle(tmp_path, field):
    cfg = _slot_file(tmp_path / "slot.dat")
    stats = S.StreamingStats()
    if field == "goldilocks":
        root = S.streaming_slot_root_gl(cfg, "poseidon2", N_CELLS // 4, stats, device="cpu")
        assert root == calc_slot_tree_gl("poseidon2", cfg).root
    else:
        root = S.streaming_slot_root(cfg, N_CELLS // 4, stats, device="cpu")
        assert root == calc_slot_tree(cfg).root
    assert stats.chunks == 4 and stats.file_reads == 4
    assert stats.as_dict()["file_reads"] == 4


def _split(monkeypatch, part_bytes, cores=8):
    """Runs of part_bytes or more split, on a host of `cores` usable cores."""
    monkeypatch.setattr(D, "MIN_PART_BYTES", part_bytes)
    monkeypatch.setattr(D.os, "sched_getaffinity", lambda pid: set(range(cores)))


@pytest.mark.parametrize(
    "cores, cells, part_bytes, parts",
    [
        (8, (0, N_CELLS), 16 * CELL, 2),  # two halves
        (8, (11, 21), 3 * CELL, 3),  # 640 bytes in 213, 213, 214: parts cut cells
        (8, (0, N_CELLS), CELL, 8),  # 32 parts' worth, capped at MAX_PARTS
        (2, (0, N_CELLS), CELL, 2),  # capped at the usable cores
    ],
    ids=["2-parts", "3-parts-uneven", "8-parts", "2-cores"],
)
def test_a_split_run_equals_the_file(tmp_path, monkeypatch, cores, cells, part_bytes, parts):
    cfg = _slot_file(tmp_path / "slot.dat")
    _split(monkeypatch, part_bytes, cores)
    before = _reads()
    got = D.load_cells(cfg, np.arange(*cells))
    want = np.fromfile(cfg.data_src.filename, np.uint8).reshape(N_CELLS, CELL)[slice(*cells)]
    assert np.array_equal(got, want)
    assert _reads() == {"bulk": before["bulk"] + 1, "cell": before["cell"],
                        "part": before["part"] + parts}


def test_a_split_file_one_byte_short_raises(tmp_path, monkeypatch):
    cfg = _slot_file(tmp_path / "slot.dat", extra=-1)
    _split(monkeypatch, 4 * CELL)
    with pytest.raises(EOFError, match="short read from slot file"):
        D.load_cells(cfg, np.arange(N_CELLS))


def test_a_part_read_short_is_completed(tmp_path, monkeypatch):
    cfg = _slot_file(tmp_path / "slot.dat")
    _split(monkeypatch, 8 * CELL)  # 4 parts of 512 bytes
    starts = {k * 8 * CELL for k in range(4)}
    preadv = os.preadv

    def first_read_short(fd, buffers, offset):
        if offset in starts:  # each part's first read returns half
            starts.discard(offset)
            (buf,) = buffers
            return preadv(fd, [buf[: len(buf) // 2]], offset)
        return preadv(fd, buffers, offset)

    monkeypatch.setattr(D.os, "preadv", first_read_short)
    before = _reads()
    got = D.load_cells(cfg, np.arange(N_CELLS))
    assert not starts
    assert np.array_equal(got, np.fromfile(cfg.data_src.filename, np.uint8).reshape(N_CELLS, CELL))
    assert _reads()["part"] == before["part"] + 8


def test_a_run_under_two_parts_is_one_read_in_the_caller(tmp_path, monkeypatch):
    cfg = _slot_file(tmp_path / "slot.dat")
    _split(monkeypatch, 8 * CELL)
    preadv, threads = os.preadv, []

    def recorded(fd, buffers, offset):
        threads.append(threading.current_thread())
        return preadv(fd, buffers, offset)

    monkeypatch.setattr(D.os, "preadv", recorded)
    before = _reads()
    got = D.load_cells(cfg, np.arange(3, 18))  # 15 cells: one part and seven eighths
    want = np.fromfile(cfg.data_src.filename, np.uint8).reshape(N_CELLS, CELL)[3:18]
    assert np.array_equal(got, want)
    assert threads == [threading.current_thread()]
    assert _reads()["part"] == before["part"] + 1 and _reads()["bulk"] == before["bulk"] + 1


def test_streaming_stats_count_the_parts_read(tmp_path, monkeypatch):
    cfg = _slot_file(tmp_path / "slot.dat")
    _split(monkeypatch, 2 * CELL)  # a chunk of 8 cells reads as 4 parts
    stats = S.StreamingStats()
    before = _reads()
    root = S.streaming_slot_root_gl(cfg, "poseidon2", N_CELLS // 4, stats, device="cpu")
    assert root == calc_slot_tree_gl("poseidon2", cfg).root
    assert (stats.chunks, stats.file_reads, stats.read_parts) == (4, 4, 16)
    assert stats.read_parts == _reads()["part"] - before["part"]
    assert stats.as_dict()["read_parts"] == 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runs_land_in_one_reused_page_locked_block(tmp_path, cuda):
    cfg = _slot_file(tmp_path / "slot.dat", n_cells=1 << 12, cell_size=2048)
    half = cfg.n_cells // 2
    first = D.load_cells(cfg, np.arange(half))
    assert torch.from_numpy(first).is_pinned()
    at = first.ctypes.data
    del first  # the block goes back to the allocator's cache
    second = D.load_cells(cfg, np.arange(half, cfg.n_cells))
    assert torch.from_numpy(second).is_pinned() and second.ctypes.data == at
    want = np.memmap(cfg.data_src.filename, np.uint8, "r").reshape(cfg.n_cells, 2048)[half:]
    assert np.array_equal(second, want)
    assert not torch.from_numpy(D.load_cells(cfg, [3, 1])).is_pinned()


@pytest.mark.cuda
def test_a_file_backed_gl_build_equals_the_same_bytes_from_the_card(tmp_path, cuda):
    cfg = _slot_file(tmp_path / "slot.dat", n_cells=1 << 18, cell_size=2048, seed=16)
    stats = S.StreamingStats()
    root = S.streaming_slot_root_gl(cfg, "poseidon2", 1 << 17, stats, device=cuda)
    assert (stats.chunks, stats.file_reads) == (2, 2)
    if len(os.sched_getaffinity(0)) > 1:  # each 256 MiB chunk reads in parts
        assert stats.read_parts > stats.file_reads
    data = np.fromfile(cfg.data_src.filename, dtype=np.uint8).reshape(cfg.n_cells, 2048)
    rows = torch.from_numpy(data).to(cuda).T
    btd = cfg.cells_per_block.bit_length() - 1
    assert root == GH.digests(GH.slot_tree_from_rows_gl("poseidon2", rows, btd)[-1])[0]
