"""Poseidon2 t=3 permutation, compression and sponges over BN254 Fr.

Pure-Python scalar reference.  Semantics match the reference circuit
(circuit/poseidon2/poseidon2_perm.circom:163-198, poseidon2_sponge.circom:28-99,
poseidon2_compr.circom:13-41) and host implementations
(reference/haskell/src/Poseidon2/{Permutation,Sponge}.hs).

Schedule: initial linear layer; 4 external rounds; 56 internal rounds;
4 external rounds.  S-box is x^5.  External MDS is circ-ish
[[2,1,1],[1,2,1],[1,1,2]] applied as out_i = sbox_i + sum(sbox); internal
matrix is [[2,1,1],[1,2,1],[1,1,3]] applied to (sbox(x0+c), x1, x2).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .bn254 import (
    P,
    EXTERNAL_ROUND_CONSTS,
    INTERNAL_ROUND_CONSTS,
)

Felt = int  # field elements are plain ints in [0, P)


def _sbox(x: Felt) -> Felt:
    x2 = (x * x) % P
    x4 = (x2 * x2) % P
    return (x4 * x) % P


def _external_round(consts, x: Felt, y: Felt, z: Felt):
    cx, cy, cz = consts
    sx = _sbox((x + cx) % P)
    sy = _sbox((y + cy) % P)
    sz = _sbox((z + cz) % P)
    s = (sx + sy + sz) % P
    return (sx + s) % P, (sy + s) % P, (sz + s) % P


def _internal_round(c: Felt, x: Felt, y: Felt, z: Felt):
    sx = _sbox((x + c) % P)
    return (
        (2 * sx + y + z) % P,
        (sx + 2 * y + z) % P,
        (sx + y + 3 * z) % P,
    )


def _linear_layer(x: Felt, y: Felt, z: Felt):
    s = (x + y + z) % P
    return (x + s) % P, (y + s) % P, (z + s) % P


def permutation(state: Sequence[Felt]) -> tuple[Felt, Felt, Felt]:
    """The full 64-round Poseidon2 t=3 permutation."""
    x, y, z = (v % P for v in state)
    x, y, z = _linear_layer(x, y, z)
    for k in range(4):
        x, y, z = _external_round(EXTERNAL_ROUND_CONSTS[k], x, y, z)
    for c in INTERNAL_ROUND_CONSTS:
        x, y, z = _internal_round(c, x, y, z)
    for k in range(4, 8):
        x, y, z = _external_round(EXTERNAL_ROUND_CONSTS[k], x, y, z)
    return x, y, z


def compression(x: Felt, y: Felt) -> Felt:
    """2-to-1 compression: first lane of permutation(x, y, 0).

    Reference: circuit/poseidon2/poseidon2_compr.circom:13-23.
    """
    return permutation((x, y, 0))[0]


def keyed_compression(key: Felt, x: Felt, y: Felt) -> Felt:
    """Keyed 2-to-1 compression: first lane of permutation(x, y, key).

    Keys 0..3 encode Merkle node type (see oracle/merkle.py).
    Reference: circuit/poseidon2/poseidon2_compr.circom:30-41,
    reference/haskell/src/Poseidon2/Merkle.hs:202-203.
    """
    return permutation((x, y, key))[0]


# ---------------------------------------------------------------------------
# Sponges.  Both use `10*` padding in field elements and the capacity IV
# civ = 2^64 + 256*t + rate  (circuit/poseidon2/poseidon2_sponge.circom:55-61).


SPONGE1_IV = (1 << 64) + 0x0301  # t=3, rate=1
SPONGE2_IV = (1 << 64) + 0x0302  # t=3, rate=2


def sponge1(inputs: Iterable[Felt]) -> Felt:
    """Rate-1 (capacity-2) sponge over field elements, squeezing one element.

    Reference: reference/haskell/src/Poseidon2/Sponge.hs:13-26.
    """
    xs = [v % P for v in inputs]
    xs.append(1)  # `10*` padding: rate 1 => always exactly one padding element
    x, y, z = 0, 0, SPONGE1_IV % P
    for a in xs:
        x, y, z = permutation(((x + a) % P, y, z))
    return x


def sponge2(inputs: Iterable[Felt]) -> Felt:
    """Rate-2 (capacity-1) sponge over field elements, squeezing one element.

    `10*` padding: append 1, then pad with a 0 if needed to a multiple of 2.
    Reference: reference/haskell/src/Poseidon2/Sponge.hs:30-43.
    """
    xs = [v % P for v in inputs]
    xs.append(1)
    if len(xs) % 2 == 1:
        xs.append(0)
    x, y, z = 0, 0, SPONGE2_IV % P
    for i in range(0, len(xs), 2):
        x, y, z = permutation(((x + xs[i]) % P, (y + xs[i + 1]) % P, z))
    return x
