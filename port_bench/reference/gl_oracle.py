"""Goldilocks hash track: Poseidon2 + Monolith permutations, digest sponges,
Merkle trees and sampling over p = 2^64 - 2^32 + 1.

Mirrors the reference's Goldilocks call surface
(reference/nim/proof_input/src/merkle/goldilocks/{poseidon2,monolith}.nim,
types/goldilocks.nim, sample/goldilocks.nim, blocks/goldilocks.nim):
Digest = 4 felts (F4), rate-8 sponges, keyed 2-digest compression with the
same Merkle key convention as BN254, per-felt low-bit extraction (k <= 56)
for sampling.  The permutation constants are instantiated per
fields/goldilocks.py (the upstream nim-goldilocks-hash pin is not vendored
in the reference; see that module's docstring for provenance).

Everything here is the scalar CPU oracle; the batched TPU kernels live in
ops/goldilocks_jnp.py and are held bit-exact to this module by tests.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .goldilocks import (
    P_GL,
    T,
    RATE,
    M4,
    RF,
    RP,
    P2GL_EXTERNAL_RC,
    P2GL_INTERNAL_RC,
    P2GL_INTERNAL_DIAG,
    MONOLITH_RC,
    MONOLITH_ROUNDS,
    MONOLITH_BARS,
    MONOLITH_CONCRETE,
)

Felt = int
Digest = tuple[int, int, int, int]

ZERO_DIGEST: Digest = (0, 0, 0, 0)

# sponge capacity IV: same formula as the BN254 sponges
# (circuit/poseidon2/poseidon2_sponge.circom:55-61: civ = 2^64 + 256*t + rate),
# reduced into the 64-bit field.
SPONGE_IV_GL = ((1 << 64) + 256 * T + RATE) % P_GL


# ---------------------------------------------------------------------------
# Poseidon2-Goldilocks t=12 permutation.


def _m4_block(x: Sequence[int]) -> list[int]:
    return [sum(M4[r][c] * x[c] for c in range(4)) % P_GL for r in range(4)]


def _external_linear(state: list[int]) -> list[int]:
    """circ(2*M4, M4, M4): out_block_i = M4 @ (x_block_i + sum_blocks)."""
    blocks = [state[i : i + 4] for i in range(0, T, 4)]
    s = [sum(b[j] for b in blocks) % P_GL for j in range(4)]
    out: list[int] = []
    for b in blocks:
        out += _m4_block([(b[j] + s[j]) % P_GL for j in range(4)])
    return out


def _internal_linear(state: list[int]) -> list[int]:
    """M_I = J + diag(mu - 1): out_i = sum(x) + (mu_i - 1) * x_i."""
    tot = sum(state) % P_GL
    return [
        (tot + (P2GL_INTERNAL_DIAG[i] - 1) * state[i]) % P_GL for i in range(T)
    ]


def _sbox7(x: int) -> int:
    x2 = x * x % P_GL
    x4 = x2 * x2 % P_GL
    return x4 * x2 % P_GL * x % P_GL


def poseidon2_permutation(state: Sequence[int]) -> list[int]:
    s = [v % P_GL for v in state]
    assert len(s) == T
    s = _external_linear(s)  # initial linear layer (Poseidon2 schedule)
    for r in range(RF // 2):
        s = [_sbox7((v + c) % P_GL) for v, c in zip(s, P2GL_EXTERNAL_RC[r])]
        s = _external_linear(s)
    for r in range(RP):
        s[0] = _sbox7((s[0] + P2GL_INTERNAL_RC[r]) % P_GL)
        s = _internal_linear(s)
    for r in range(RF // 2, RF):
        s = [_sbox7((v + c) % P_GL) for v, c in zip(s, P2GL_EXTERNAL_RC[r])]
        s = _external_linear(s)
    return s


# ---------------------------------------------------------------------------
# Monolith-64 t=12 permutation (paper structure: Concrete, then per round
# Bars -> Bricks -> Concrete -> + round constants; 6 rounds, last without
# constants).


def _bar8(x: int) -> int:
    """8-bit bar: y = rotl1(x ^ (rotl1(~x) & rotl2(x) & rotl3(x)))."""
    rot = lambda v, k: ((v << k) | (v >> (8 - k))) & 0xFF
    y = x ^ (rot(~x & 0xFF, 1) & rot(x, 2) & rot(x, 3))
    return rot(y, 1)


_BAR_LUT = [_bar8(x) for x in range(256)]


def _bar64(x: int) -> int:
    out = 0
    for b in range(8):
        out |= _BAR_LUT[(x >> (8 * b)) & 0xFF] << (8 * b)
    return out  # bytewise map keeps the value < 2^64; reduce at use sites


def _bricks(state: list[int]) -> list[int]:
    """Feistel: out_i = x_i + x_{i-1}^2 (original values), out_0 = x_0."""
    out = [state[0]]
    for i in range(1, T):
        out.append((state[i] + state[i - 1] * state[i - 1]) % P_GL)
    return out


def _concrete(state: list[int]) -> list[int]:
    """Monolith Concrete: the Plonky2-compatible 12x12 MDS matmul
    (fields/goldilocks.py MONOLITH_CONCRETE, small integer entries)."""
    return [
        sum(MONOLITH_CONCRETE[r][c] * state[c] for c in range(T)) % P_GL
        for r in range(T)
    ]


def monolith_permutation(state: Sequence[int]) -> list[int]:
    s = [v % P_GL for v in state]
    assert len(s) == T
    s = _concrete(s)  # initial Concrete
    for r in range(MONOLITH_ROUNDS):
        s = [_bar64(s[i]) % P_GL if i < MONOLITH_BARS else s[i] for i in range(T)]
        s = _bricks(s)
        s = _concrete(s)
        s = [(v + c) % P_GL for v, c in zip(s, MONOLITH_RC[r])]
    return s


PERMUTATIONS = {
    "poseidon2": poseidon2_permutation,
    "monolith": monolith_permutation,
}


# ---------------------------------------------------------------------------
# Digest ops: compression, sponges, marshalling.


def compress(hash_fun: str, key: int, x: Digest, y: Digest) -> Digest:
    """Keyed 2-digest -> 1-digest compression: first 4 lanes of
    perm(x || y || (key,0,0,0)) (merkle/goldilocks/poseidon2.nim:18)."""
    perm = PERMUTATIONS[hash_fun]
    out = perm(list(x) + list(y) + [key, 0, 0, 0])
    return tuple(out[:4])


def digest_felts(hash_fun: str, inputs: Iterable[int]) -> Digest:
    """Rate-8 sponge over felts with 10* felt padding; squeeze one digest
    (digestFeltsC(rate=8, xs), merkle/goldilocks/poseidon2.nim:19)."""
    perm = PERMUTATIONS[hash_fun]
    xs = [v % P_GL for v in inputs]
    xs.append(1)
    while len(xs) % RATE:
        xs.append(0)
    s = [0] * (T - 1) + [SPONGE_IV_GL]
    for i in range(0, len(xs), RATE):
        for j in range(RATE):
            s[j] = (s[j] + xs[i + j]) % P_GL
        s = perm(s)
    return tuple(s[:4])


CHUNK_BYTES_GL = 62  # 62 bytes = 8 x 62-bit felts = 2 digests per chunk


def bytes_to_felts_gl(data: bytes) -> list[int]:
    """10* byte padding to a multiple of 62 bytes; each chunk is 496 bits
    split little-endian into 8 felts of 62 bits (all < 2^62 < p), i.e. two
    digests per chunk (padAndDecodeBytesToDigest62 + digestSeqToFeltSeq,
    json/goldilocks.nim:19-25)."""
    buf = data + b"\x01"
    buf += b"\x00" * ((-len(buf)) % CHUNK_BYTES_GL)
    felts: list[int] = []
    mask62 = (1 << 62) - 1
    for i in range(0, len(buf), CHUNK_BYTES_GL):
        v = int.from_bytes(buf[i : i + CHUNK_BYTES_GL], "little")
        for j in range(8):
            felts.append((v >> (62 * j)) & mask62)
    return felts


def bytes_to_digests_gl(data: bytes) -> list[Digest]:
    fs = bytes_to_felts_gl(data)
    return [tuple(fs[i : i + 4]) for i in range(0, len(fs), 4)]


def digest_bytes(hash_fun: str, data: bytes) -> Digest:
    """digestBytesC(rate=8, bytes): marshal then rate-8 felt sponge."""
    return digest_felts(hash_fun, bytes_to_felts_gl(data))


def int_to_digest(v: int) -> Digest:
    return (v % P_GL, 0, 0, 0)


def digests_to_felts(ds: Sequence[Digest]) -> list[int]:
    return [f for d in ds for f in d]


def extract_low_bits_gl(felt: int, k: int) -> int:
    """Low k bits of the canonical form, k <= 56 (types/goldilocks.nim:32-36)."""
    assert 0 < k <= 56
    return felt & ((1 << k) - 1)


# ---------------------------------------------------------------------------
# Merkle + sampling over digests (the generic keyed convention of
# oracle/merkle.py, with the zero sentinel mapped to the zero digest).


def compress_fn(hash_fun: str):
    def fn(key: int, x, y) -> Digest:
        xd = ZERO_DIGEST if x == 0 else x
        yd = ZERO_DIGEST if y == 0 else y
        return compress(hash_fun, key, xd, yd)

    return fn


def sample_cell_index_gl(
    hash_fun: str, entropy: Digest, slot_root: Digest, n_cells: int, counter: int
) -> int:
    """Low log2(nCells) bits of lane 0 of the rate-8 digest of
    [entropy, slotRoot, intToDigest(counter)] (sample/goldilocks.nim:17-38)."""
    log2 = (n_cells - 1).bit_length()
    assert 1 << log2 == n_cells, "nCells must be a power of two"
    inp = digests_to_felts([entropy, slot_root, int_to_digest(counter)])
    h = digest_felts(hash_fun, inp)
    return extract_low_bits_gl(h[0], log2)
