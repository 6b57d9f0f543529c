"""Merkle trees under the Codex "safe" keyed-compression convention.

Key encoding (2 bits):
  bit0 = 1 iff bottom (widest) layer;  bit1 = 1 iff odd node (single child).
So key in {0: inner-even, 1: bottom-even, 2: inner-odd, 3: bottom-odd}.
Odd nodes compress (x, 0).  A singleton input still gets one bottom-odd
compression.  A layer of width 1 above the bottom terminates the tree.

Semantics follow reference/haskell/src/Poseidon2/Merkle.hs:69-83,156-208 and
reference/nim/proof_input/src/merkle/bn254.nim:29-63.  Proof extraction uses
the general non-power-of-two rule with zero-filled missing siblings
(reference/nim/proof_input/src/merkle.nim:21-42 — the Nim behavior, which is
the general one; the Haskell extractor assumes power-of-two widths).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from .poseidon2 import keyed_compression

Felt = int

KEY_NONE = 0x0
KEY_BOTTOM_LAYER = 0x1
KEY_ODD = 0x2
KEY_ODD_AND_BOTTOM_LAYER = 0x3

CompressFn = Callable[[int, Felt, Felt], Felt]


@dataclass
class MerkleTree:
    """layers[0] is the bottom (widest) layer; layers[-1] is [root]."""

    layers: list[list[Felt]]

    @property
    def depth(self) -> int:
        return len(self.layers) - 1

    @property
    def num_leaves(self) -> int:
        return len(self.layers[0])

    @property
    def root(self) -> Felt:
        top = self.layers[-1]
        assert len(top) == 1, "topmost layer is not a singleton"
        return top[0]


@dataclass
class MerkleProof:
    leaf_index: int
    leaf_value: Felt
    merkle_path: list[Felt]
    num_leaves: int

    def padded(self, new_len: int) -> "MerkleProof":
        """Zero-pad the path to a statically known length.

        Reference: reference/nim/proof_input/src/types.nim:27-37.
        """
        pad = new_len - len(self.merkle_path)
        assert pad >= 0, "padded: path longer than requested length"
        return MerkleProof(
            leaf_index=self.leaf_index,
            leaf_value=self.leaf_value,
            merkle_path=self.merkle_path + [0] * pad,
            num_leaves=self.num_leaves,
        )


def _build_layer(xs: Sequence[Felt], bottom: bool, compress: CompressFn) -> list[Felt]:
    half = len(xs) // 2
    even_key = KEY_BOTTOM_LAYER if bottom else KEY_NONE
    odd_key = KEY_ODD_AND_BOTTOM_LAYER if bottom else KEY_ODD
    ys = [compress(even_key, xs[2 * i], xs[2 * i + 1]) for i in range(half)]
    if len(xs) % 2 == 1:
        ys.append(compress(odd_key, xs[-1], 0))
    return ys


def merkle_tree(leaves: Sequence[Felt], compress: CompressFn = keyed_compression) -> MerkleTree:
    """Build the full tree (all layers kept, bottom first)."""
    assert len(leaves) > 0, "merkle_tree: input is empty"
    layers = [list(leaves)]
    bottom = True
    # NB: a singleton *bottom* layer still gets one bottom-odd compression;
    # a singleton layer above the bottom is the root.
    while len(layers[-1]) > 1 or bottom:
        layers.append(_build_layer(layers[-1], bottom, compress))
        bottom = False
    return MerkleTree(layers)


def merkle_root(leaves: Sequence[Felt], compress: CompressFn = keyed_compression) -> Felt:
    return merkle_tree(leaves, compress).root


def extract_proof(tree: MerkleTree, index: int) -> MerkleProof:
    """Merkle path for leaf `index`, bottom to top; zero for missing siblings."""
    n = tree.num_leaves
    assert 0 <= index < n
    path: list[Felt] = []
    k, m = index, n
    for layer in tree.layers[: tree.depth]:
        j = k ^ 1
        path.append(layer[j] if j < m else 0)
        k >>= 1
        m = (m + 1) >> 1
    return MerkleProof(index, tree.layers[0][index], path, n)


def reconstruct_root(proof: MerkleProof, compress: CompressFn = keyed_compression) -> Felt:
    """Walk the path up, re-deriving the odd/even/bottom keys from the index
    and the shrinking layer width (reference/nim/proof_input/src/merkle.nim:51-74).
    """
    m = proof.num_leaves
    j = proof.leaf_index
    h = proof.leaf_value
    bottom_flag = 1
    for p in proof.merkle_path:
        if j & 1:
            h = compress(bottom_flag, p, h)
        elif j == m - 1:
            h = compress(bottom_flag + 2, h, p)  # odd node, single child
        else:
            h = compress(bottom_flag, h, p)
        bottom_flag = 0
        j >>= 1
        m = (m + 1) >> 1
    return h


def check_proof(root: Felt, proof: MerkleProof, compress: CompressFn = keyed_compression) -> bool:
    return reconstruct_root(proof, compress) == root


def merge_proofs(
    bottom_proof: MerkleProof,
    top_proof: MerkleProof,
    compress: CompressFn = keyed_compression,
) -> MerkleProof:
    """Graft a fixed-size bottom-tree proof onto a top-tree proof.

    The bottom tree's root must be the top proof's leaf.
    Reference: reference/nim/proof_input/src/merkle.nim:86-100.
    """
    bot_root = reconstruct_root(bottom_proof, compress)
    assert bot_root == top_proof.leaf_value, "merge_proofs: root/leaf mismatch"
    return MerkleProof(
        leaf_index=top_proof.leaf_index * bottom_proof.num_leaves + bottom_proof.leaf_index,
        leaf_value=bottom_proof.leaf_value,
        merkle_path=bottom_proof.merkle_path + top_proof.merkle_path,
        num_leaves=bottom_proof.num_leaves * top_proof.num_leaves,
    )
