"""Vectorized data sources: fake-data PRNG and file-backed slots.

The fake-data PRNG is bit-for-bit the reference's mock backend
(reference/nim/proof_input/src/slot.nim:22-32 == Slot.hs:87-96): a sequential
uint64 recurrence per cell, with deliberate wraparound semantics.  The
recurrence is sequential in the byte index but independent across cells, so
it vectorizes across the cell axis: one numpy uint64 state vector stepped
cell_size times.  (The scalar oracle in oracle/slot.py is the semantic
anchor; tests check equality.)

A file-backed slot is read by load_cells: a contiguous run of cells (a
streaming chunk) into one block, page-locked where a CUDA device is
present, and any other index list (sampled cells) a cell at a time.  A run
of at least two MIN_PART_BYTES parts is split into up to one disjoint part
a usable core, each a positioned read (os.preadv, which releases the GIL)
on a thread of a pool made at the first such run: copying out of the page
cache is bound by the core that does it.  Its other functions are copies of
the JAX package's.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from ..oracle.slot import FAKE_MODULUS, SlotConfig

_U64 = np.uint64

# File reads of load_cells, as kernels.build.LAUNCHES counts launches:
# "bulk" runs of cells read (one a run, however it is split), "cell" reads
# of one cell, "part" the positioned reads of the runs (short returns
# included).
FILE_READS = {"bulk": 0, "cell": 0, "part": 0}

MIN_PART_BYTES = 16 << 20  # a run splits into parts of at least this size
MAX_PARTS = 8

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def gen_fake_cells(cell_size: int, seed: int, cell_indices) -> np.ndarray:
    """(B,) cell indices -> (B, cell_size) uint8 fake cell data.

    Vectorized across cells; sequential (as specified) along the byte axis.
    Contiguous index ranges route through the native C PRNG when built
    (native/cspc_native.c cspc_fake_cells — ~6x the numpy path; equality
    covered by tests/test_native.py).
    """
    idx = np.asarray(cell_indices, dtype=np.uint64)
    b = idx.shape[0]
    if b > 1 and idx[0] + b - 1 == idx[-1] and np.all(np.diff(idx) == 1):
        from .. import native

        if native.available():
            return native.fake_cells(cell_size, seed, int(idx[0]), b)
    seed1 = _U64((seed + 0xDEADCAFE) & 0xFFFFFFFFFFFFFFFF)
    seed2 = (idx + _U64(0x98765432 % (1 << 64)))  # wraps in uint64
    out = np.empty((b, cell_size), dtype=np.uint8)
    state = np.ones(b, dtype=np.uint64)
    xor_c = _U64(0x5A5A5A5A)
    c17 = _U64(17)
    mod = _U64(FAKE_MODULUS)
    with np.errstate(over="ignore"):
        for i in range(cell_size):
            t = state * (state + seed1)
            t = t * (state + seed2)
            t = t + state * (state ^ xor_c)
            t = t + seed1 * state
            t = t + (seed2 + c17)
            state = t % mod
            out[:, i] = (state & _U64(0xFF)).astype(np.uint8)
    return out


def load_slot_cells(cfg: SlotConfig) -> np.ndarray:
    """All cells of a slot as one (n_cells, cell_size) uint8 array."""
    src = cfg.data_src
    if src.kind == "fake":
        return gen_fake_cells(cfg.cell_size, src.seed, np.arange(cfg.n_cells))
    data = np.fromfile(src.filename, dtype=np.uint8, count=cfg.n_cells * cfg.cell_size)
    assert data.size == cfg.n_cells * cfg.cell_size, "short read from slot file"
    return data.reshape(cfg.n_cells, cfg.cell_size)


def _host_buffer(b: int, cell_size: int) -> np.ndarray:
    """(b, cell_size) uint8 for a run of cells.  With a CUDA device it is a
    view of page-locked memory from PyTorch's caching host allocator: the
    copy to the card is then one DMA, and the block is pinned and faulted in
    once and reused by later runs of the same size once this view is
    released."""
    if torch.cuda.is_available():
        return torch.empty((b, cell_size), dtype=torch.uint8, pin_memory=True).numpy()
    return np.empty((b, cell_size), dtype=np.uint8)


def _read_part(fd: int, view: memoryview, offset: int) -> int:
    """Fill view from the file's bytes at offset: one positioned read, and
    another only after a short return.  Returns the reads made."""
    got = reads = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        reads += 1
        if n == 0:
            raise EOFError("short read from slot file")
        got += n
    return reads


def _n_parts(n_bytes: int) -> int:
    return max(1, min(len(os.sched_getaffinity(0)), MAX_PARTS, n_bytes // MIN_PART_BYTES))


def _read_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(MAX_PARTS, thread_name_prefix="cspc-read")
        return _pool


def _read_run(filename: str, offset: int, out: np.ndarray) -> None:
    """Fill out (C-contiguous) from the file's bytes at offset.  Split into
    _n_parts disjoint parts, read at once on the pool's threads (one part:
    in this thread); returns when every part is complete, and raises the
    first part's error."""
    view = memoryview(out.reshape(-1))
    n_parts = _n_parts(len(view))
    cuts = [len(view) * k // n_parts for k in range(n_parts + 1)]
    fd = os.open(filename, os.O_RDONLY)
    try:
        if n_parts == 1:
            reads = _read_part(fd, view, offset)
        else:
            pool, parts = _read_pool(), []
            try:
                for a, b in zip(cuts, cuts[1:]):
                    parts.append(pool.submit(_read_part, fd, view[a:b], offset + a))
            finally:
                wait(parts)  # no part may still write into out or read fd
            reads = sum(p.result() for p in parts)
    finally:
        os.close(fd)
    FILE_READS["bulk"] += 1
    FILE_READS["part"] += reads


def load_cells(cfg: SlotConfig, cell_indices) -> np.ndarray:
    """Random-access batch of cells as (B, cell_size) uint8.

    From a file, indices that form one ascending run with step 1 are read
    into _host_buffer by _read_run, in parallel parts once the run is large
    enough; any other list is read a cell at a time.  A file too short
    raises EOFError.
    """
    src = cfg.data_src
    idx = np.asarray(cell_indices, dtype=np.int64)
    if src.kind == "fake":
        return gen_fake_cells(cfg.cell_size, src.seed, idx)
    b = idx.shape[0]
    if b and idx[0] + b - 1 == idx[-1] and np.all(np.diff(idx) == 1):
        out = _host_buffer(b, cfg.cell_size)
        _read_run(src.filename, cfg.cell_size * int(idx[0]), out)
        return out
    out = np.empty((b, cfg.cell_size), dtype=np.uint8)
    with open(src.filename, "rb") as f:
        for row, i in enumerate(idx):
            f.seek(cfg.cell_size * int(i))
            buf = f.read(cfg.cell_size)
            FILE_READS["cell"] += 1
            if len(buf) != cfg.cell_size:
                raise EOFError("short read from slot file")
            out[row] = np.frombuffer(buf, dtype=np.uint8)
    return out
