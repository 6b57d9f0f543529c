"""Goldilocks field (p = 2^64 - 2^32 + 1) and the two canonical hash instances.

The reference's Goldilocks track lives in the external pinned dependency
`nim-goldilocks-hash` (reference/nim/proof_input/proof_input.nimble:13), which
is NOT vendored in the reference repo; only the call surface is
(reference/nim/proof_input/src/merkle/goldilocks/{poseidon2,monolith}.nim,
types/goldilocks.nim).  This module instantiates the two permutations from
their published canonical specifications:

* **Poseidon2-Goldilocks, t=12, alpha=7, R_F=8, R_P=22** — the instance of the
  Poseidon2 reference implementation (HorizenLabs/poseidon2,
  `poseidon2_instance_goldilocks.rs`, mirrored by Plonky3's
  `goldilocks/src/poseidon2.rs`):
  - Round constants are generated by the canonical Grain-LFSR procedure of the
    Poseidon/Poseidon2 reference scripts (`generate_params_poseidon2.sage`)
    with init (field=1 ["GF(p)"], sbox=0 ["x^alpha"], n=64, t=12, R_F=8,
    R_P=22): an 80-bit LFSR b_{i+80} = b_{i+62}^b_{i+51}^b_{i+38}^b_{i+23}
    ^b_{i+13}^b_i, 160 warm-up bits, self-shrinking output, 64-bit big-endian
    draws with rejection sampling, **R_F*t + R_P = 118 field elements total**
    assigned in temporal order: 4 initial external rounds (t each), 22
    internal rounds (1 each), 4 final external rounds (t each).
  - The internal matrix is M_I = J + diag(v) with v the published *searched*
    vector MAT_DIAG12_M_1 (NOT Grain-drawn), transcribed below.
  - Both are anchored at import time: the generated external round-0 row and
    internal constant 0 are asserted against values transcribed from the
    published instance (`_ANCHOR_*` below).  Since the Grain stream is one
    deterministic sequence, matching its head pins the whole table.

* **Monolith-64, t=12, R=6 rounds** — per the Monolith paper (eprint
  2023/1025) and its reference implementation:
  - Structure Concrete then per-round Bars(u=4, 8-bit lookups) -> Bricks ->
    Concrete -> add round constants; the last round adds none.
  - Round constants from SHAKE-128 over the reference implementation's
    domain: "Monolith" || [t, R] || p.to_le_bytes(8) || [8]*8 (the eight
    8-bit bar limb widths), each constant 8 bytes little-endian with
    rejection sampling, (R-1)*t constants in round order.
  - The Concrete matrix for t=12 is the Plonky2 Poseidon MDS matrix (chosen
    by the Monolith paper for Plonky2 compatibility): row r of M is
    CIRC[(c - r) mod 12] plus DIAG[r] on the diagonal, with
    CIRC = [17,15,41,16,2,28,13,13,39,18,34,20], DIAG = [8,0,...,0].

Everything downstream (oracle/goldilocks.py, ops/goldilocks_jnp.py,
ops/goldilocks_pallas.py, native/cspc_gl.c via tools/gen_gl_c_constants.py)
is table-driven from this module.
"""

from __future__ import annotations

import hashlib

P_GL = (1 << 64) - (1 << 32) + 1  # Goldilocks prime

T = 12  # state width
RATE = 8  # sponge rate (reference merkle/goldilocks/poseidon2.nim:19-20)
CAPACITY = 4  # Digest = F4 (reference types/goldilocks.nim: Digest, F4)

# Poseidon2 schedule
RF = 8  # external (full) rounds, split 4 + 4
RP = 22  # internal (partial) rounds
ALPHA = 7  # S-box power (x^7; gcd(7, p-1) = 1)

# The 4x4 block of the Poseidon2 external matrix circ(2*M4, M4, ..., M4)
M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)

# Published internal-matrix diagonal of the canonical Poseidon2-Goldilocks
# t=12 instance: M_I = J + diag(P2GL_INTERNAL_DIAG_M1).  Transcribed from
# HorizenLabs/poseidon2 `poseidon2_instance_goldilocks.rs` (MAT_DIAG12_M_1),
# identical in Plonky3 `goldilocks::MATRIX_DIAG_12_GOLDILOCKS`.  This vector
# is a searched constant, not Grain output.
P2GL_INTERNAL_DIAG_M1 = (
    0xC3B6C08E23BA9300,
    0xD84B5DE94A324FB6,
    0x0D0C371C5B35B84F,
    0x7964F570E7188037,
    0x5DAF18BBD996604B,
    0x6743BC47B9595257,
    0x5528B9362C59BB70,
    0xAC45E25B7127B68B,
    0xA2077D7DFBB606B5,
    0xF3FAAC6FAEE378AE,
    0x0C6388B51545E883,
    0xD27DBB6944917B60,
)

# Consumers historically use `sum(x) + (diag_i - 1) * x_i`; keep that contract
# by exporting the full diagonal entries of M_I (= published value + 1).
P2GL_INTERNAL_DIAG = tuple((v + 1) % P_GL for v in P2GL_INTERNAL_DIAG_M1)


# ---------------------------------------------------------------------------
# Grain LFSR (the canonical Poseidon/Poseidon2 constant-generation procedure).


class _GrainLFSR:
    """80-bit Grain LFSR, initialized per the Poseidon reference script:
    2 bits field type (GF(p)=01), 4 bits sbox (x^alpha=0000), 12 bits n,
    12 bits t, 10 bits RF, 10 bits RP, 30 ones; 160 warm-up bits dropped;
    self-shrinking output (emit a bit only when the preceding bit is 1)."""

    def __init__(self, n_bits: int, t: int, rf: int, rp: int):
        bits = []
        bits += [0, 1]  # field = GF(p)
        bits += [0, 0, 0, 0]  # sbox = x^alpha
        for width, val in ((12, n_bits), (12, t), (10, rf), (10, rp)):
            bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        b = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [b]
        return b

    def next_bit(self) -> int:
        while True:
            if self._next_raw() == 1:
                return self._next_raw()
            self._next_raw()

    def next_felt(self, p: int, n_bits: int) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if v < p:
                return v


def _gen_poseidon2_round_constants():
    """Canonical Poseidon2 draw: R_F*t + R_P field elements from one Grain
    stream, split (R_F/2)*t || R_P || (R_F/2)*t in temporal round order."""
    g = _GrainLFSR(64, T, RF, RP)
    flat = [g.next_felt(P_GL, 64) for _ in range(RF * T + RP)]
    half = (RF // 2) * T
    ext_first = [flat[i * T : (i + 1) * T] for i in range(RF // 2)]
    intr = flat[half : half + RP]
    tail = flat[half + RP :]
    ext_last = [tail[i * T : (i + 1) * T] for i in range(RF // 2)]
    return ext_first + ext_last, intr


P2GL_EXTERNAL_RC, P2GL_INTERNAL_RC = _gen_poseidon2_round_constants()

# Anchors transcribed from the published instance (Plonky3
# `HL_GOLDILOCKS_12_EXTERNAL_ROUND_CONSTANTS[0]` /
# `HL_GOLDILOCKS_12_INTERNAL_ROUND_CONSTANTS[0]`, identical to the
# HorizenLabs RC12 tables).  One deterministic stream -> matching the head
# certifies every later draw.
_ANCHOR_EXTERNAL_RC0 = (
    0x13DCF33ABA214F46,
    0x30B3B654A1DA6D83,
    0x1FC634ADA6159B56,
    0x937459964DC03466,
    0xEDD2EF2CA7949924,
    0xEDE9AFFDE0E22F68,
    0x8515B9D6BAC9282D,
    0x6B5C07B4E9E900D8,
    0x1EC66368838C8A08,
    0x9042367D80D1FBAB,
    0x400283564A3C3799,
    0x4A00BE0466BCA75E,
)
_ANCHOR_INTERNAL_RC0 = 0x4ADF842AA75D4316

assert tuple(P2GL_EXTERNAL_RC[0]) == _ANCHOR_EXTERNAL_RC0, (
    "Grain stream does not reproduce the published Poseidon2-Goldilocks t=12 "
    "external round constants"
)
assert P2GL_INTERNAL_RC[0] == _ANCHOR_INTERNAL_RC0, (
    "Grain stream split does not reproduce the published internal round "
    "constants"
)


# ---------------------------------------------------------------------------
# Monolith-64 t=12 constants.

MONOLITH_ROUNDS = 6
MONOLITH_BARS = 4  # Bars applied to the first 4 state elements (u = 4)

# Concrete matrix = the Plonky2 Poseidon MDS matrix (Monolith paper choice
# for t=12, for Plonky2 compatibility): M[r][c] = CIRC[(c-r) mod 12]
# (+ DIAG[r] when r == c).  Transcribed from Plonky2
# `hash/poseidon.rs` (GoldilocksField: MDS_MATRIX_CIRC / MDS_MATRIX_DIAG).
MONOLITH_CONCRETE_CIRC = (17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20)
MONOLITH_CONCRETE_DIAG = (8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)

MONOLITH_CONCRETE = tuple(
    tuple(
        MONOLITH_CONCRETE_CIRC[(c - r) % T] + (MONOLITH_CONCRETE_DIAG[r] if r == c else 0)
        for c in range(T)
    )
    for r in range(T)
)


def _gen_monolith_constants():
    """Round constants per the Monolith reference implementation: SHAKE-128
    over "Monolith" || [t, R] || p_le8 || [8]*8; each constant is 8 bytes
    little-endian with rejection sampling; t constants per round for rounds
    1..R-1 in order; the final round adds no constants."""
    shake = hashlib.shake_128()
    shake.update(b"Monolith")
    shake.update(bytes([T, MONOLITH_ROUNDS]))
    shake.update(P_GL.to_bytes(8, "little"))
    shake.update(bytes([8, 8, 8, 8, 8, 8, 8, 8]))  # bar limb widths
    # hashlib SHAKE cannot stream reads, but digest(n) is exactly the first n
    # XOF bytes; 4x headroom makes rejection exhaustion impossible in practice.
    stream = shake.digest(MONOLITH_ROUNDS * T * 8 * 4)
    pos = 0

    def draw():
        nonlocal pos
        while True:
            v = int.from_bytes(stream[pos : pos + 8], "little")
            pos += 8
            if v < P_GL:
                return v

    rc = [[draw() for _ in range(T)] for _ in range(MONOLITH_ROUNDS - 1)]
    rc.append([0] * T)  # last round: no constants
    return rc




MONOLITH_RC = _gen_monolith_constants()
