"""Byte -> field-element encoding on torch tensors.

Port of codex_storage_proofs_circuits_tpu/ops/encode.py: `10*` byte
padding, 31-byte little-endian chunks, each chunk one canonical felt
(< 2^248 < P) laid out as (NL, B) int32 limb planes.  Bytes pair up into
16-bit limbs; limb 15 is the single top byte 30 (Slot.hs:243-270).

The work happens on byte rows (nbytes, B), byte i of every cell in row i:
that is the layout the fake-data PRNG emits, and it packs straight into
(nchunks, NL, B) planes with no transpose.
"""

from __future__ import annotations

import torch

NL = 16
CHUNK_BYTES = 31


def n_chunks(nbytes: int) -> int:
    """Number of 31-byte chunks after `10*` padding (always >= 1)."""
    return (nbytes + 1 + CHUNK_BYTES - 1) // CHUNK_BYTES


def _pad_rows(rows: torch.Tensor, dtype) -> torch.Tensor:
    """(nbytes, B) byte rows -> (n_chunks*31, B) of dtype with the 0x01
    marker row and zero fill."""
    nbytes, b = rows.shape
    out = torch.zeros((n_chunks(nbytes) * CHUNK_BYTES, b), dtype=dtype, device=rows.device)
    out[:nbytes] = rows
    out[nbytes] = 1
    return out


def _rows_to_felt_limbs(padded: torch.Tensor) -> torch.Tensor:
    """(n_chunks*31, B) padded byte rows -> (nchunks, NL, B) int32 limbs."""
    total, b = padded.shape
    if total % CHUNK_BYTES:
        raise ValueError(f"{total} bytes is not a whole number of 31-byte chunks")
    ch = padded.to(torch.int32).reshape(total // CHUNK_BYTES, CHUNK_BYTES, b)
    limbs = torch.empty((ch.shape[0], NL, b), dtype=torch.int32, device=padded.device)
    limbs[:, : NL - 1] = ch[:, 0:30:2] | (ch[:, 1:31:2] << 8)  # bytes 0..29
    limbs[:, NL - 1] = ch[:, 30]  # byte 30
    return limbs


def pad_bytes(data: torch.Tensor) -> torch.Tensor:
    """(B, nbytes) uint8 -> (B, n_chunks*31) uint8 with the 0x01 marker."""
    return _pad_rows(data.T, torch.uint8).T


def bytes_to_felt_limbs(data: torch.Tensor) -> torch.Tensor:
    """(B, nbytes) uint8, already `10*` padded (nbytes a multiple of 31) ->
    (nchunks, NL, B) canonical felt limbs."""
    return _rows_to_felt_limbs(data.T)


def encode_rows(rows: torch.Tensor) -> torch.Tensor:
    """(cell_size, B) uint8 byte rows -> (nfelts, NL, B) canonical felts."""
    return _rows_to_felt_limbs(_pad_rows(rows, torch.int32))


def encode_cells(data: torch.Tensor) -> torch.Tensor:
    """(B, cell_size) uint8 raw cell bytes -> (nfelts, NL, B) canonical felts."""
    return encode_rows(data.T)
