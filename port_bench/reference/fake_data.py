"""The reference's fake-data generator, vectorized over cells in numpy.

A frozen copy of the numpy path of the port's `models/data.gen_fake_cells`
(the reference mock backend, slot.nim:22-32 == Slot.hs:87-96): one uint64
state a cell, stepped once a byte with deliberate wraparound and a final
`mod FAKE_MODULUS`.  `slot.gen_fake_cell` is the scalar version.
"""

from __future__ import annotations

import numpy as np

from .slot import FAKE_MODULUS

_U64 = np.uint64


def gen_fake_cells(cell_size: int, seed: int, cell_indices) -> np.ndarray:
    """(B,) cell indices -> (B, cell_size) uint8 fake cell data."""
    idx = np.asarray(cell_indices, dtype=np.uint64)
    seed1 = _U64((seed + 0xDEADCAFE) & 0xFFFFFFFFFFFFFFFF)
    seed2 = idx + _U64(0x98765432)  # wraps in uint64
    out = np.empty((idx.shape[0], cell_size), dtype=np.uint8)
    state = np.ones(idx.shape[0], dtype=np.uint64)
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
