"""The card's peaks and the kernels' counted work, for roofline shares.

Fixed here, so that the yardstick does not move with the machine or with
the program: an NVIDIA H100 SXM (data sheet) moves 3.35 TB/s of device
memory, and each of its 132 SMs issues 64 32-bit integer multiplies a clock
at the maximum SM clock, 1980 MHz.

Counted work (copied from the port's chip_smoke.py, where each count is
derived from the CUDA sources): each mul.lo / mul.hi / mad.lo / mad.hi
counts 1, multiplies by the small constants of the linear layers are left
out.
  BN254: a Montgomery product 264, a squaring 208, x^5 two squarings and a
    product; a Poseidon2 permutation 80 S-boxes (3 in each of 8 external
    rounds, 1 in each of 56 internal ones).
  Goldilocks: a modular product 8; Poseidon2-GL 736 products a permutation.
Bytes: what the inputs need, each input byte read once and each output
byte written once; a digest is 16 int32 limb planes (64 bytes).
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_CLOCK, SM_CLOCK_HZ = 132, 64, 1.98e9
IMAD_PER_S = SMS * IMAD_PER_CLOCK * SM_CLOCK_HZ

BN254_MUL, BN254_SQR = 264, 208
BN254_PERM = 80 * (2 * BN254_SQR + BN254_MUL)  # 54,400
GL_PERM = {"poseidon2": 736 * 8, "monolith": 66 * 8}
DIGEST_BYTES = 64


def bound_s(n_bytes: float, muls: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the multiplies over the multiply rate."""
    return max(n_bytes / MEM_BYTES_PER_S, muls / IMAD_PER_S)


def bn254_felts(cell_size: int) -> int:
    """31-byte felts of a cell after its `10*` byte padding."""
    return (cell_size + 1 + 30) // 31


def bn254_cell_bound_s(cell_size: int) -> float:
    """K2: one cell's hash from its bytes, a rate-2 sponge over its felts
    and their felt padding, plus one product (by R^2) a felt into
    Montgomery form."""
    nf = bn254_felts(cell_size)
    blocks = (nf + 1 + 1) // 2
    return bound_s(cell_size + DIGEST_BYTES, blocks * BN254_PERM + nf * BN254_MUL)


def bn254_tree_bound_s(n_leaves: int) -> float:
    """K1: a whole tree over n_leaves Montgomery cell hashes, every layer
    written canonical: n - 1 compressions, one product a node out of
    Montgomery form."""
    return bound_s(DIGEST_BYTES * (n_leaves + 2 * n_leaves - 1),
                   (n_leaves - 1) * BN254_PERM + (2 * n_leaves - 1) * BN254_MUL)


def gl_cell_bound_s(cell_size: int, hash_fun: str) -> float:
    """K6: one cell's digest from its bytes, 62-byte chunks of 8 felts into
    a rate-8 sponge, plus the padding block."""
    chunks = (cell_size + 1 + 61) // 62
    return bound_s(cell_size + DIGEST_BYTES, (chunks + 1) * GL_PERM[hash_fun])
