"""Vectorized data sources: fake-data PRNG and file-backed slots.

The fake-data PRNG is bit-for-bit the reference's mock backend
(reference/nim/proof_input/src/slot.nim:22-32 == Slot.hs:87-96): a sequential
uint64 recurrence per cell, with deliberate wraparound semantics.  The
recurrence is sequential in the byte index but independent across cells, so
it vectorizes across the cell axis: one numpy uint64 state vector stepped
cell_size times.  (The scalar oracle in oracle/slot.py is the semantic
anchor; tests check equality.)
"""

from __future__ import annotations

import numpy as np

from ..oracle.slot import FAKE_MODULUS, SlotConfig

_U64 = np.uint64


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


def load_cells(cfg: SlotConfig, cell_indices) -> np.ndarray:
    """Random-access batch of cells as (B, cell_size) uint8."""
    src = cfg.data_src
    idx = np.asarray(cell_indices, dtype=np.int64)
    if src.kind == "fake":
        return gen_fake_cells(cfg.cell_size, src.seed, idx)
    out = np.empty((idx.shape[0], cfg.cell_size), dtype=np.uint8)
    with open(src.filename, "rb") as f:
        for row, i in enumerate(idx):
            f.seek(cfg.cell_size * int(i))
            buf = f.read(cfg.cell_size)
            assert len(buf) == cfg.cell_size, "short read from slot file"
            out[row] = np.frombuffer(buf, dtype=np.uint8)
    return out
