"""Witness-level evaluation of the SampleAndProve constraint system.

models/circuit.py checks the *statement* at integer-semantics altitude; this
module works at the *witness* altitude of the reference circuit templates:
it generates a full named witness assignment for `SampleAndProve` and
re-evaluates every circuit constraint directly on that assignment, in field
arithmetic mod r.  Tampering any constrained witness value is caught.

Template models (each cites its reference source):

  * ToBits(n)                 circuit/lib/misc.circom:16-28
  * IsZero / IsEqual          circuit/lib/misc.circom:33-59  (inverse witness)
  * BinaryCompare(n)          circuit/lib/binary_compare.circom:20-41
                              (jump/eq/aux recurrence, 3n-1 constraints)
  * ExtractLowerBits(n)       circuit/lib/extract_bits.circom:17-40
                              (254-bit decomposition + enforced  bits < r)
  * Log2(n)                   circuit/lib/log2.circom:13-40 (== the
                              witnesscalc hack :49-95 at constraint level)
  * CeilingLog2(n)            circuit/lib/log2.circom:108-130
  * RootFromMerklePath(d)     circuit/codex/merkle.circom:44-114, including
                              the singleton maskBitsCorrected[0]=1 fixup
                              (:53-62), the isLast prefix-equality chain
                              (:73-81) and the switch/key logic (:84-104)
  * ProveSingleCell           circuit/codex/single_cell.circom:30-73
  * CalculateCellIndexBits    circuit/codex/sample_cells.circom:23-48
  * SampleAndProve            circuit/codex/sample_cells.circom:58-148

The Poseidon2 permutation is treated as an atomic gate: each invocation's
full (x, y, z) output state is part of the witness and is re-derived from
its input state on evaluation (the permutation itself is bit-exactly tested
against the circuit's constants elsewhere; modelling all ~250 R1CS signals
per permutation would add nothing but volume).

Signals that are genuinely unconstrained in the reference circuit (the
IsZero inverse witness when inp == 0, merkle.circom's maskBits[0] which is
overridden by maskBitsCorrected) are reported in `WitnessBundle.free`, and
the tamper test asserts that every *other* signal is load-bearing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.bn254 import P
from ..oracle.poseidon2 import permutation, SPONGE2_IV
from ..oracle.sampling import ProofInput
from ..oracle.dataset import GlobalConfig, DataSetConfig

# bits of the field prime r, least significant first (extract_bits.circom:27)
PRIME_BITS = [(P >> i) & 1 for i in range(254)]


class ConstraintError(AssertionError):
    """A circuit `===` constraint failed on the witness assignment."""


@dataclass
class WitnessBundle:
    """A named witness assignment plus its unconstrained-signal set.

    `p` is the proving-field modulus: BN254 r by default, or a small test
    prime (65537) for exhaustive template enumeration — the analogue of the
    reference harness's pluggable proving field (test/Main.hs:22-44,
    circuit/lib/extract_bits.circom:50-73).
    """

    values: dict[str, int] = field(default_factory=dict)
    free: set[str] = field(default_factory=set)
    p: int = P

    def set(self, name: str, v: int, free: bool = False) -> int:
        v %= self.p
        assert name not in self.values, f"duplicate signal {name}"
        self.values[name] = v
        if free:
            self.free.add(name)
        return v

    def __getitem__(self, name: str) -> int:
        return self.values[name]


# ---------------------------------------------------------------------------
# Shared template walkers.  Each template is one function used in BOTH modes:
#   gen  — compute hint (<--) signals from the inputs and store them
#   eval — read every signal from the bundle and check each ===
# In eval mode the stored (possibly tampered) signal values are used for all
# downstream computation, exactly like a malicious prover's witness would be.


class _Ctx:
    def __init__(self, w: WitnessBundle, gen: bool):
        self.w = w
        self.gen = gen
        self.p = w.p
        # field size in bits (ExtractLowerBits decomposition width):
        # 254 for BN254 r, 17 for the 65537 test field
        # (extract_bits.circom:27 vs :50-73)
        self.n_field_bits = self.p.bit_length()

    def hint(self, name: str, value_fn, free: bool = False) -> int:
        """A `<--` assignment: computed in gen mode, read back in eval mode."""
        if self.gen:
            return self.w.set(name, value_fn() % self.p, free)
        return self.w[name]

    def assign(self, name: str, value: int) -> int:
        """A `<==` assignment: constrained equal, so store in gen mode and
        check in eval mode."""
        value %= self.p
        if self.gen:
            return self.w.set(name, value)
        got = self.w[name]
        if got != value:
            raise ConstraintError(f"{name}: {got} !== {value}")
        return got

    def require(self, what: str, a: int, b: int = 0) -> None:
        """A bare `===` constraint."""
        if not self.gen and (a - b) % self.p != 0:
            raise ConstraintError(f"{what}: {a % self.p} !== {b % self.p}")


def _to_bits(c: _Ctx, pfx: str, inp: int, n: int) -> list[int]:
    """ToBits(n) (misc.circom:16-28)."""
    bits = []
    for i in range(n):
        b = c.hint(f"{pfx}.out[{i}]", lambda i=i: (inp >> i) & 1)
        c.require(f"{pfx}.bool[{i}]", b * (1 - b) % c.p)
        bits.append(b)
    s = sum((1 << i) * b for i, b in enumerate(bits)) % c.p
    c.require(f"{pfx}.sum", s, inp)
    return bits


def _is_equal(c: _Ctx, pfx: str, a: int, b: int) -> int:
    """IsEqual via IsZero's inverse-witness trick (misc.circom:33-59)."""
    inp = (a - b) % c.p
    inv = c.hint(
        f"{pfx}.inv",
        lambda: pow(inp, c.p - 2, c.p) if inp != 0 else 0,
        free=(inp == 0),  # any inverse satisfies the constraints when inp==0
    )
    out = c.assign(f"{pfx}.out", (1 - inp * inv) % c.p)
    c.require(f"{pfx}.zero", inp * out % c.p)
    return out


def _binary_compare(c: _Ctx, pfx: str, A: list[int], B: list[int]) -> int:
    """BinaryCompare(n) (binary_compare.circom:20-41).  Returns the field
    value of `out` (p-1 encodes -1)."""
    n = len(A)
    assert len(B) == n
    jump = {n: 1}
    total = 0
    for k in range(n - 1, -1, -1):
        y = (A[k] - B[k]) % c.p
        eq = c.assign(f"{pfx}.eq[{k}]", (1 - y * y) % c.p)
        jump[k] = c.assign(f"{pfx}.jump[{k}]", eq * jump[k + 1] % c.p)
        aux = c.assign(f"{pfx}.aux[{k}]", (jump[k + 1] - jump[k]) * y % c.p)
        total = (total + aux) % c.p
    return c.assign(f"{pfx}.out", total)


def _extract_lower_bits(c: _Ctx, pfx: str, inp: int, n: int) -> list[int]:
    """ExtractLowerBits(n) (extract_bits.circom:17-40): full field-width
    decomposition with the enforced `bits < r` via BinaryCompare.  Over the
    65537 test field the width is 17 with that prime's bits, matching
    ExtractLowerBits_testfield65537 (extract_bits.circom:50-73)."""
    nb = c.n_field_bits
    prime_bits = PRIME_BITS if c.p == P else [(c.p >> i) & 1 for i in range(nb)]
    bits = _to_bits(c, f"{pfx}.tb", inp, nb)
    out = _binary_compare(c, f"{pfx}.le", bits, prime_bits)
    c.require(f"{pfx}.lt_prime", out, c.p - 1)  # out === -1
    return bits[:n]


def _log2(c: _Ctx, pfx: str, inp: int, n: int) -> tuple[int, list[int]]:
    """Log2(n) (log2.circom:13-40; constraint-identical to the
    witnesscalc hack at :49-95).  Returns (out, mask[0..n])."""
    mask = [
        c.hint(f"{pfx}.mask[{i}]", lambda i=i: 1 if (1 << i) < inp else 0)
        for i in range(n + 1)
    ]
    out = c.hint(
        f"{pfx}.out",
        lambda: next((i for i in range(n + 1) if (1 << i) == inp), -1),
    )
    c.require(f"{pfx}.mask0", mask[0], 1)
    c.require(f"{pfx}.maskn", mask[n])
    s = 0
    for i in range(n):
        d = (mask[i] - mask[i + 1]) % c.p
        s = (s + (1 << (i + 1)) * d) % c.p
        c.require(f"{pfx}.step[{i}]", d * (i + 1 - out) % c.p)
    c.require(f"{pfx}.sum", s, inp)
    return out, mask


def _ceiling_log2(c: _Ctx, pfx: str, inp: int, n: int):
    """CeilingLog2(n) (log2.circom:108-130): (out, bits(inp-1), mask)."""
    bits = _to_bits(c, f"{pfx}.tb", (inp - 1) % c.p, n)
    aux = {n: 1}
    s = 0
    for i in range(n - 1, -1, -1):
        aux[i] = c.assign(f"{pfx}.aux[{i}]", aux[i + 1] * (1 - bits[i]) % c.p)
    mask = []
    for i in range(n):
        mask.append(c.assign(f"{pfx}.mask[{i}]", (1 - aux[i]) % c.p))
    for i in range(n - 1, -1, -1):
        s = (s + (aux[i + 1] - aux[i]) * (i + 1)) % c.p
    mask.append(c.assign(f"{pfx}.mask[{n}]", 0))
    out = c.assign(f"{pfx}.out", s)
    return out, bits, mask


def _keyed_compression_gate(c: _Ctx, pfx: str, key: int, x: int, y: int) -> int:
    """One KeyedCompression as an atomic permutation gate: the output state
    is witness; evaluation re-derives it from (x, y, key).  BN254-only: the
    permutation constants live in Fr (the reference harness likewise keeps
    the hash circuits out of its small-field solver tests, test/Main.hs)."""
    assert c.p == P, "permutation gates require the BN254 field"
    exp = permutation((x % P, y % P, key % P))
    got = [c.assign(f"{pfx}.perm.{lane}", v) for lane, v in zip("xyz", exp)]
    return got[0]


def _root_from_merkle_path(
    c: _Ctx,
    pfx: str,
    leaf: int,
    path_bits: list[int],
    last_bits: list[int],
    mask_bits: list[int],
    merkle_path: list[int],
) -> int:
    """RootFromMerklePath(maxDepth) (merkle.circom:44-114)."""
    d = len(path_bits)
    assert len(last_bits) == d and len(merkle_path) == d and len(mask_bits) == d + 1

    # singleton fixup (merkle.circom:53-62): maskBitsCorrected[0] <== 1
    corrected = [1] + list(mask_bits[1:])

    # isLast prefix-equality chain, reverse bit order (merkle.circom:73-81)
    is_last = {d: 1}
    for i in range(d - 1, -1, -1):
        eq = _is_equal(c, f"{pfx}.eq[{i}]", path_bits[i], last_bits[i])
        is_last[i] = c.assign(f"{pfx}.isLast[{i}]", is_last[i + 1] * eq % c.p)

    # the hash chain with switch/key logic (merkle.circom:84-104)
    aux = c.assign(f"{pfx}.aux[0]", leaf)
    for i in range(d):
        bottom = 1 if i == 0 else 0
        odd = is_last[i] * (1 - path_bits[i]) % c.p
        l_in, r_in = aux, merkle_path[i]
        switch = c.assign(f"{pfx}.switch[{i}]", (r_in - l_in) * path_bits[i] % c.p)
        key = (bottom + 2 * odd) % c.p
        out = _keyed_compression_gate(
            c, f"{pfx}.comp[{i}]", key, (l_in + switch) % c.p, (r_in - switch) % c.p
        )
        aux = c.assign(f"{pfx}.aux[{i+1}]", out)

    # layer selection (merkle.circom:106-113)
    total = 0
    for i in range(d):
        prod = c.assign(
            f"{pfx}.prods[{i}]",
            (corrected[i] - corrected[i + 1]) * c.w[f"{pfx}.aux[{i+1}]"] % c.p,
        )
        total = (total + prod) % c.p
    return total


def _sponge2_hash_gates(c: _Ctx, pfx: str, felts: list[int]) -> int:
    """Poseidon2_hash_rate2(n): rate-2 sponge with felt 10* padding
    (poseidon2_sponge.circom:28-99), permutations as atomic gates.
    BN254-only (see _keyed_compression_gate)."""
    assert c.p == P, "sponge gates require the BN254 field"
    padded = list(felts) + [1]
    if len(padded) % 2:
        padded.append(0)
    x, y, z = 0, 0, SPONGE2_IV % P
    for blk in range(0, len(padded), 2):
        ex, ey, ez = permutation(
            ((x + padded[blk]) % P, (y + padded[blk + 1]) % P, z)
        )
        x = c.assign(f"{pfx}.st[{blk//2}].x", ex)
        y = c.assign(f"{pfx}.st[{blk//2}].y", ey)
        z = c.assign(f"{pfx}.st[{blk//2}].z", ez)
    return x


def _calculate_cell_index_bits(
    c: _Ctx, pfx: str, entropy: int, slot_root: int, counter: int, mask: list[int], max_depth: int
) -> list[int]:
    """CalculateCellIndexBits(maxLog2N) (sample_cells.circom:23-48)."""
    h = _sponge2_hash_gates(c, f"{pfx}.pos", [entropy, slot_root, counter])
    md = _extract_lower_bits(c, f"{pfx}.md", h, max_depth)
    return [
        c.assign(f"{pfx}.indexBits[{i}]", mask[i] * md[i] % c.p)
        for i in range(max_depth)
    ]


def _prove_single_cell(
    c: _Ctx,
    pfx: str,
    slot_root: int,
    data: list[int],
    last_bits: list[int],
    index_bits: list[int],
    mask_bits: list[int],
    merkle_path: list[int],
    bot_depth: int,
    max_depth: int,
) -> None:
    """ProveSingleCell (single_cell.circom:30-73)."""
    cell_hash = _sponge2_hash_gates(c, f"{pfx}.hash", data)
    bot_root = _root_from_merkle_path(
        c,
        f"{pfx}.pbot",
        cell_hash,
        index_bits[:bot_depth],
        last_bits[:bot_depth],
        mask_bits[:bot_depth] + [0],
        merkle_path[:bot_depth],
    )
    rec = _root_from_merkle_path(
        c,
        f"{pfx}.pmid",
        bot_root,
        index_bits[bot_depth:],
        last_bits[bot_depth:],
        mask_bits[bot_depth:max_depth] + [0],
        merkle_path[bot_depth:],
    )
    c.require(f"{pfx}.slot_root", rec, slot_root)


def _sample_and_prove(c: _Ctx, glob: GlobalConfig, pi: ProofInput) -> None:
    """SampleAndProve (sample_cells.circom:58-148)."""
    max_depth = glob.max_depth
    mlns = glob.max_log2_n_slots
    btd = glob.block_tree_depth

    # dataset-level inclusion (sample_cells.circom:95-109)
    tbtp = _to_bits(c, "tbtp", pi.slot_index, mlns)
    _clog_out, clog_bits, clog_mask = _ceiling_log2(c, "clog", pi.n_slots_per_dataset, mlns)
    rec_top = _root_from_merkle_path(
        c, "mtop", pi.slot_root, tbtp, clog_bits, clog_mask, list(pi.slot_proof)
    )
    c.require("mtop.dataset_root", rec_top, pi.data_set_root)

    # nCells mask (sample_cells.circom:115-123)
    _lg_out, lg_mask = _log2(c, "lg", pi.n_cells_per_slot, max_depth)
    last_bits = lg_mask[:max_depth]

    for cnt in range(len(pi.cell_data)):
        pfx = f"s{cnt}"
        index_bits = _calculate_cell_index_bits(
            c, f"{pfx}.calci", pi.entropy, pi.slot_root, cnt + 1, lg_mask, max_depth
        )
        _prove_single_cell(
            c,
            f"{pfx}.prove",
            pi.slot_root,
            list(pi.cell_data[cnt]),
            last_bits,
            index_bits,
            lg_mask,
            list(pi.merkle_paths[cnt]),
            btd,
            max_depth,
        )


def generate_witness(glob: GlobalConfig, pi: ProofInput) -> WitnessBundle:
    """Full named witness assignment for SampleAndProve on this proof input."""
    w = WitnessBundle()
    _sample_and_prove(_Ctx(w, gen=True), glob, pi)
    return w


def evaluate_witness(glob: GlobalConfig, pi: ProofInput, w: WitnessBundle) -> None:
    """Re-evaluate every circuit constraint on the (possibly tampered)
    witness; raises ConstraintError on the first violation."""
    _sample_and_prove(_Ctx(w, gen=False), glob, pi)
