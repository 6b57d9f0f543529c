"""Goldilocks cell encoding on torch tensors: bytes -> 62-bit felt limbs.

Port of codex_storage_proofs_circuits_tpu/ops/gl_encode.py (the device
encode) and of the host encode models/gl_hashing.py::encode_cells_gl; one
implementation serves both here.  Semantics (oracle/goldilocks.py
bytes_to_felts_gl, json/goldilocks.nim:19-25): `10*` byte padding to a
multiple of 62 bytes, each 62-byte chunk split little-endian into 8 felts of
62 bits, each felt (4, B) int32 planes of 16-bit limbs.

A 16-bit limb spans at most 3 consecutive bytes of its chunk, so the encode
is one gather of three bytes per (felt-in-chunk, limb) from the (bytes, B)
rows, then shifts and masks.  Byte rows are the layout the fake-data PRNG
emits (byte i of every cell in row i), so nothing is transposed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .gl_oracle import CHUNK_BYTES_GL  # 62

NL = 4
FELT_BITS = 62
LIMB_BITS = 16
FELTS_PER_CHUNK = 8


def n_chunks(cell_size: int) -> int:
    """62-byte chunks of a cell after `10*` padding."""
    return (cell_size + 1 + CHUNK_BYTES_GL - 1) // CHUNK_BYTES_GL


def n_felts(cell_size: int) -> int:
    return FELTS_PER_CHUNK * n_chunks(cell_size)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """For each (felt-in-chunk, limb), j = 4 * felt + limb: the indices of
    its three bytes in a chunk (62 = a zero byte appended to each chunk),
    its bit shift and its mask."""
    idx = np.zeros((3, FELTS_PER_CHUNK * NL), np.int64)
    shift = np.zeros((FELTS_PER_CHUNK * NL, 1), np.int32)
    mask = np.zeros((FELTS_PER_CHUNK * NL, 1), np.int32)
    for sub in range(FELTS_PER_CHUNK):
        for limb in range(NL):
            j = NL * sub + limb
            bit0 = FELT_BITS * sub + LIMB_BITS * limb
            for k in range(3):
                idx[k, j] = min(bit0 // 8 + k, CHUNK_BYTES_GL)
            shift[j] = bit0 % 8
            mask[j] = (1 << min(LIMB_BITS, FELT_BITS - LIMB_BITS * limb)) - 1  # 16,16,16,14
    return tuple(torch.from_numpy(a).to(device) for a in (idx, shift, mask))


def encode_rows(rows: torch.Tensor) -> torch.Tensor:
    """(cell_size, B) byte rows (any integer dtype) -> (nfelts, 4, B) int32
    canonical felt limbs, with the `10*` padding applied here."""
    cell_size, b = rows.shape
    nch = n_chunks(cell_size)
    buf = torch.zeros((nch * CHUNK_BYTES_GL, b), dtype=torch.int32, device=rows.device)
    buf[:cell_size] = rows
    buf[cell_size] = 1
    buf = torch.cat([buf.reshape(nch, CHUNK_BYTES_GL, b), buf.new_zeros((nch, 1, b))], 1)
    idx, shift, mask = _tables(rows.device)
    g = buf[:, idx]  # (nch, 3, 32, B)
    v = (g[:, 0] >> shift) | (g[:, 1] << (8 - shift)) | (g[:, 2] << (16 - shift))
    return (v & mask).reshape(nch * FELTS_PER_CHUNK, NL, b)


def encode_cells(cells: torch.Tensor) -> torch.Tensor:
    """(B, cell_size) uint8 raw cell bytes -> (nfelts, 4, B) felt limbs."""
    return encode_rows(cells.T)
