"""Slot data model: cells, blocks, byte->field encoding, fake data, slot trees.

Semantics follow reference/haskell/src/Slot.hs and
reference/nim/proof_input/src/{slot,blocks/bn254}.nim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .bn254 import P
from .poseidon2 import SPONGE2_IV, permutation
from .merkle import MerkleTree, MerkleProof, merkle_tree, extract_proof, merge_proofs

Felt = int

MASK64 = (1 << 64) - 1
FAKE_MODULUS = 1698428844001831  # fake-data PRNG modulus (slot.nim:30)


# ---------------------------------------------------------------------------
# Fake data PRNG (the deterministic mock data backend).
# uint64 wraparound semantics are part of the spec
# (reference/nim/proof_input/src/slot.nim:22-32 == Slot.hs:87-96).


def gen_fake_cell(cell_size: int, seed: int, cell_idx: int) -> bytes:
    seed1 = (seed + 0xDEADCAFE) & MASK64
    seed2 = (cell_idx + 0x98765432) & MASK64
    state = 1
    out = bytearray(cell_size)
    for i in range(cell_size):
        state = (
            state * (state + seed1) % (1 << 64) * ((state + seed2) & MASK64)
            + state * (state ^ 0x5A5A5A5A)
            + seed1 * state
            + (seed2 + 17)
        ) & MASK64
        state = state % FAKE_MODULUS
        out[i] = state & 0xFF
    return bytes(out)


def gen_fake_block(cell_size: int, cells_per_block: int, seed: int, block_idx: int) -> bytes:
    a = cells_per_block * block_idx
    return b"".join(
        gen_fake_cell(cell_size, seed, a + j) for j in range(cells_per_block)
    )


# ---------------------------------------------------------------------------
# Byte -> field encoding: `10*` byte padding + 31-byte little-endian chunks
# (reference/haskell/src/Slot.hs:243-270).

CHUNK_BYTES = 31


def pad_and_split_bytes(data: bytes, k: int = CHUNK_BYTES) -> list[bytes]:
    """Append a 0x01 byte, then 0x00s up to a multiple of k; split into chunks.

    Note an exact multiple of k still gains one extra (mostly-zero) chunk,
    because the 0x01 marker is always appended.
    """
    buf = data + b"\x01"
    rem = (-len(buf)) % k
    buf += b"\x00" * rem
    return [buf[i : i + k] for i in range(0, len(buf), k)]


def chunk_to_field(chunk: bytes) -> Felt:
    assert len(chunk) == CHUNK_BYTES
    return int.from_bytes(chunk, "little")  # < 2^248 < P, already canonical


def cell_data_to_field_elements(data: bytes) -> list[Felt]:
    return [chunk_to_field(c) for c in pad_and_split_bytes(data)]


def field_elems_per_cell(cell_size: int) -> int:
    """= ceil((cell_size+1)/31) (Slot.hs:81-82 computes (cellSize+30)//31,
    identical for cell sizes not congruent 0 mod 31; the +1 is the 0x01 pad)."""
    return (cell_size + 30) // 31


# ---------------------------------------------------------------------------
# Cell hashing: rate-2 sponge over the encoded field elements
# (blocks/bn254.nim:23-29, Slot.hs:222-228).  Inlined sponge2 so callers can
# reuse the felt encoding.


def hash_cell_felts(felts: Sequence[Felt]) -> Felt:
    xs = list(felts)
    xs.append(1)  # felt-level `10*` padding
    if len(xs) % 2 == 1:
        xs.append(0)
    x, y, z = 0, 0, SPONGE2_IV % P
    for i in range(0, len(xs), 2):
        x, y, z = permutation(((x + xs[i]) % P, (y + xs[i + 1]) % P, z))
    return x


def hash_cell_bytes(data: bytes) -> Felt:
    """Sponge.digest(bytes, rate=2): byte `10*` padding into 31-byte LE felts,
    then felt `10*` padding into the rate-2 sponge."""
    return hash_cell_felts(cell_data_to_field_elements(data))


# ---------------------------------------------------------------------------
# Slot configuration + trees.


@dataclass(frozen=True)
class DataSource:
    """FakeData(seed) or SlotFile(filename) (types.nim:64-74)."""

    kind: str  # "fake" | "file"
    seed: int = 0
    filename: str = ""


@dataclass(frozen=True)
class SlotConfig:
    cell_size: int  # bytes, e.g. 2048
    block_size: int  # bytes, e.g. 65536
    n_cells: int  # cells per slot (power of two)
    n_samples: int
    data_src: DataSource

    @property
    def cells_per_block(self) -> int:
        q, r = divmod(self.block_size, self.cell_size)
        assert r == 0, "block size not divisible by cell size"
        return q

    @property
    def blocks_per_slot(self) -> int:
        q, r = divmod(self.n_cells, self.cells_per_block)
        assert r == 0, "slot size not divisible by block size"
        return q


def load_cell(cfg: SlotConfig, idx: int) -> bytes:
    src = cfg.data_src
    if src.kind == "fake":
        return gen_fake_cell(cfg.cell_size, src.seed, idx)
    with open(src.filename, "rb") as f:
        f.seek(cfg.cell_size * idx)
        data = f.read(cfg.cell_size)
    assert len(data) == cfg.cell_size, "short read from slot file"
    return data


def load_block(cfg: SlotConfig, idx: int) -> bytes:
    k = cfg.cells_per_block
    return b"".join(load_cell(cfg, idx * k + j) for j in range(k))


def block_tree(cfg: SlotConfig, block_data: bytes) -> MerkleTree:
    """Depth-5 (for 64KB/2KB) mini tree over the cell hashes of one block
    (blocks/bn254.nim:60-67)."""
    assert len(block_data) == cfg.block_size
    cs = cfg.cell_size
    leaves = [
        hash_cell_bytes(block_data[i * cs : (i + 1) * cs])
        for i in range(cfg.cells_per_block)
    ]
    return merkle_tree(leaves)


@dataclass
class SlotTree:
    mini_trees: list[MerkleTree]  # one per block
    big_tree: MerkleTree  # over the block roots

    @property
    def root(self) -> Felt:
        return self.big_tree.root


def calc_slot_tree(cfg: SlotConfig) -> SlotTree:
    """cells -> block mini-trees -> big tree over block roots
    (gen_input/bn254.nim:21-30; built once, layers kept for path extraction)."""
    minis = [block_tree(cfg, load_block(cfg, b)) for b in range(cfg.blocks_per_slot)]
    big = merkle_tree([t.root for t in minis])
    return SlotTree(minis, big)


def extract_cell_proof(cfg: SlotConfig, slot_tree: SlotTree, cell_idx: int) -> MerkleProof:
    """Merged (block-path ++ slot-path) proof for one cell
    (Slot.hs:181-187, gen_input/bn254.nim:58-63)."""
    k = cfg.cells_per_block
    block_idx, within = divmod(cell_idx, k)
    bot = extract_proof(slot_tree.mini_trees[block_idx], within)
    top = extract_proof(slot_tree.big_tree, block_idx)
    return merge_proofs(bot, top)


def check_cell_proof(
    cfg: SlotConfig, slot_root: Felt, cell_idx: int, cell_hash: Felt, path: Sequence[Felt]
) -> bool:
    """Two-stage verification of a merged cell proof (Slot.hs:189-217).

    The merged path does NOT verify under a single reconstruct_root pass: the
    slot-level tree's bottom layer is re-marked as "bottom" when the path is
    split (the circuit does the same, single_cell.circom:41-60).
    """
    k = cfg.cells_per_block
    m = cfg.blocks_per_slot
    log_k = (k - 1).bit_length()
    log_m = (m - 1).bit_length()
    assert 1 << log_k == k, "cells per block must be a power of two"
    if log_k + log_m != len(path):
        raise ValueError("check_cell_proof: incorrect Merkle path length")

    block_idx = cell_idx >> log_k
    in_block_idx = cell_idx & (k - 1)

    from .merkle import reconstruct_root  # local import to avoid cycle noise

    small = MerkleProof(in_block_idx, cell_hash, list(path[:log_k]), k)
    block_hash = reconstruct_root(small)
    big = MerkleProof(block_idx, block_hash, list(path[log_k:]), m)
    return reconstruct_root(big) == slot_root
