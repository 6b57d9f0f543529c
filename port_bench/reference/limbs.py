"""BN254 Fr arithmetic on 16-bit limb planes, in plain torch.

Port of codex_storage_proofs_circuits_tpu/ops/limbs.py.  A field batch is a
(16, *T) tensor of little-endian 16-bit limbs.  At the package boundary the
planes are torch.int32 holding values below 2^16 (the JAX twin's uint32
planes): on the CPU torch's uint32 has no `+`, `>>` or `>=`, so every
function here widens to int64 inside and hands back the dtype it was given.
16x16-bit products and their column sums stay far below 2^63.

Montgomery form with radix R = 2^256.  mont_mul is CIOS over the 16 limbs
of b with the whole running sum kept as unresolved int64 columns; carries
resolve once at the end.  These are the plain versions: the CUDA kernels (csrc/) do the
same arithmetic on 8 x 32-bit limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bn254

NL = bn254.NUM_LIMBS  # 16
LB = bn254.LIMB_BITS  # 16
MASK = bn254.LIMB_MASK  # 0xffff

# BN254 Fr has P == 1 (mod 2^16), so the per-limb Montgomery quotient is
# -column0 mod 2^16 and P's limb 0 contributes exactly that quotient.
assert bn254.P_INV_NEG_16 == MASK and bn254.P & MASK == 1


def int_limbs(x: int, n: int = NL) -> list[int]:
    """Integer -> n little-endian 16-bit limbs."""
    return [(x >> (LB * i)) & MASK for i in range(n)]


R2_LIMBS = int_limbs(bn254.R2_MONT)
ONE_LIMBS = int_limbs(1)


@functools.lru_cache(maxsize=None)
def _const(x: int, device: torch.device, ndim: int) -> torch.Tensor:
    """Integer -> int64 limb column (16, 1, ..., 1) of `ndim` dims on `device`."""
    col = torch.tensor(int_limbs(x), dtype=torch.int64, device=device)
    return col.reshape((NL,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# Host-side packing helpers


def pack(values, device=None) -> torch.Tensor:
    """Iterable of python ints -> (NL, B) int32 limb planes."""
    values = list(values)
    arr = np.zeros((NL, len(values)), dtype=np.int32)
    for b, v in enumerate(values):
        arr[:, b] = int_limbs(v)
    return torch.from_numpy(arr).to(device)


def unpack(limbs: torch.Tensor) -> list[int]:
    """(NL, B) limb planes -> list of python ints."""
    arr = limbs.detach().cpu().numpy()
    acc = np.zeros(arr.shape[1], dtype=object)
    for i in range(arr.shape[0]):
        acc |= arr[i].astype(np.int64).astype(object) << (LB * i)
    return [int(v) for v in acc]


# ---------------------------------------------------------------------------
# Carry / borrow resolution.  After one carry pass every limb is at most
# 0x10000, so a limb either generates a carry (== 0x10000) or propagates an
# incoming one (== 0xffff), never both.  Packing those 0/1 flags of the 16
# limbs into one integer per column turns the carry chain into a single
# integer addition (the same chain as a binary adder's), in place of the JAX
# twin's log2(16) Kogge-Stone doubling steps.


@functools.lru_cache(maxsize=None)
def _limb_index(device: torch.device, ndim: int) -> torch.Tensor:
    """(NL, 1, ..., 1) int64 column 0, 1, ..., NL-1."""
    w = torch.arange(NL, dtype=torch.int64, device=device)
    return w.reshape((NL,) + (1,) * (ndim - 1))


def _resolve(gen: torch.Tensor, prop: torch.Tensor):
    """Carry chain c[i+1] = gen[i] | (prop[i] & c[i]) over the limb axis.

    gen/prop: exclusive 0/1 int64 planes (NL, *T).  Returns (carry into
    each limb (NL, *T), carry out of the top limb (*T))."""
    sh = _limb_index(gen.device, gen.ndim)
    g = (gen << sh).sum(0)
    a = (prop << sh).sum(0) | g
    s = a + g  # a binary adder with these inputs carries exactly like the chain
    cin = s ^ a ^ g  # bit i = carry into limb i
    return (cin.unsqueeze(0) >> sh) & 1, s >> NL


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """Move each column's bits above 16 one limb up; the top carry is dropped."""
    hi = x >> LB
    hi[-1] = 0
    return (x & MASK) + hi.roll(1, 0)


def _normalize(x: torch.Tensor, max_col_bits: int) -> torch.Tensor:
    bits = max_col_bits
    # fixed passes until limbs are <= 0x10000
    while bits > 17:
        x = _carry_pass(x)
        bits = max(17, bits - LB + 1)
    x = _carry_pass(x)
    low = x & MASK
    cin, _ = _resolve(x >> LB, (low == MASK).to(torch.int64))
    return (low + cin) & MASK


def normalize(cols: torch.Tensor, max_col_bits: int = 22) -> torch.Tensor:
    """Carry-saved columns (K, *T), each non-negative and below
    2^max_col_bits -> canonical 16-bit limbs, mod 2^(16K) (a carry out of
    the top limb is dropped; every caller's value fits the container)."""
    if cols.shape[0] != NL:
        raise ValueError(f"normalize: {cols.shape[0]} limbs, expected {NL}")
    return _normalize(cols.to(torch.int64), max_col_bits).to(cols.dtype)


def _sub_with_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b on canonical int64 limb planes; returns (diff mod 2^256,
    borrow_out (*T) in {0, 1})."""
    t = a - b  # in (-2^16, 2^16)
    borrow_in, borrow_out = _resolve((t < 0).to(torch.int64), (t == 0).to(torch.int64))
    return (t - borrow_in) & MASK, borrow_out


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """Reduce a canonical-limb value < 2P modulo P (one conditional subtract)."""
    diff, borrow = _sub_with_borrow(x, _const(bn254.P, x.device, x.ndim))
    return torch.where(borrow == 0, diff, x)


# ---------------------------------------------------------------------------
# Public modular ops (canonical in, canonical out, input dtype kept)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod P on (NL, *T) limb planes."""
    s = a.to(torch.int64) + b.to(torch.int64)  # a+b < 2P < 2^255 fits 16 limbs
    return _cond_sub_p(_normalize(s, 17)).to(a.dtype)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod P on (NL, *T) limb planes."""
    diff, borrow = _sub_with_borrow(a.to(torch.int64), b.to(torch.int64))
    plus_p = _normalize(diff + _const(bn254.P, a.device, a.ndim), 17)
    return torch.where(borrow == 0, diff, plus_p).to(a.dtype)


def mont_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod P on (NL, *T) limb planes.

    b is a limb-plane tensor broadcastable to a, or a list of 16 python-int
    limbs (a constant operand).  CIOS: for each limb b_j, add a*b_j to the
    running columns, add the quotient multiple of P that zeroes the lowest
    column, and move the lowest column's carry up.  The window slides up a
    2*NL-column buffer in place instead of shifting the sum down.  Columns
    stay below 16 * 2^33 + carries < 2^38; the value below 2P.
    Inputs canonical (< P); output canonical.
    """
    a64 = a.to(torch.int64)
    const = isinstance(b, (list, tuple))
    if not const:
        b = b.to(torch.int64)
        a64, b = torch.broadcast_tensors(a64, b)
    p = _const(bn254.P, a64.device, a64.ndim)
    cols = a64.new_zeros((2 * NL + 1,) + a64.shape[1:])
    for j in range(NL):
        win = cols[j : j + NL]
        if not const or b[j]:
            win += a64 * b[j]
        m = (-win[0]) & MASK  # quotient: P == 1 (mod 2^16)
        win += p * m
        cols[j + 1] += win[0] >> LB  # column j is now 0 mod 2^16
    res = _normalize(cols[NL : 2 * NL], 38)
    return _cond_sub_p(res).to(a.dtype)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical standard form -> Montgomery form."""
    return mont_mul(a, R2_LIMBS)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical standard form."""
    return mont_mul(a, ONE_LIMBS)
