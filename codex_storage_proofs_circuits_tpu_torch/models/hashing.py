"""Batched hashing pipeline pieces: cell hashing and Merkle layer reduction.

Port of codex_storage_proofs_circuits_tpu/models/hashing.py.  One launch
of kernel K2 hashes every cell of a batch at once, straight from its byte
rows (the byte encode, the Montgomery form and the felt padding happen in
the kernel), and the subtree kernel (K1) builds the slot tree's layers
from the cell hashes, many levels a launch, and writes them canonical.
tree_reduce_layers keeps the JAX twin's API (Montgomery layers, one
batched keyed compression a layer).  Layers are (NL, W) int32 limb
planes.  The felt entry points (hash_cells_mont, slot_tree_from_felts) are
the JAX package's API, kept for the parity tests.

The JAX twin's TPU machinery is not carried over: the 512-lane padding of
the Pallas tile (the CUDA kernels take any width), and the fixed-width
scan over the narrow tail layers (it bounded XLA compile time; here a
plain per-layer loop runs each layer as it is).
"""

from __future__ import annotations

import torch

from ..ops import limbs as L
from ..ops import poseidon2_cuda as P2C
from ..ops.poseidon2_plain import pad_felts_rate2, to_mont_stack

NL = L.NL

# The kernel wrappers are the dispatch points: CUDA tensors launch K1/K2,
# CPU tensors take the plain versions.
permute = P2C.permutation  # (3, NL, B) -> (3, NL, B)
compress_layer = P2C.compress_layer  # (NL, B), (NL, B), key -> (NL, B)
tree_layers = P2C.tree_layers  # (NL, B) layer, levels, key bits -> canonical layers
sponge2_scan = P2C.sponge2_absorb  # (nb, 2, NL, B) -> (NL, B)
hash_cells_rows = P2C.sponge2_rows  # (cell_size, B) uint8 rows -> (NL, B)


def hash_cells_mont(cells_felts: torch.Tensor) -> torch.Tensor:
    """(nfelts, NL, B) canonical felts (byte-encoded cells) -> (NL, B)
    Montgomery cell hashes (rate-2 sponge with felt `10*` padding)."""
    return sponge2_scan(pad_felts_rate2(to_mont_stack(cells_felts)))


def _check_width(b: int, stop_width: int) -> None:
    if stop_width < 1 or b % stop_width:
        raise ValueError(f"width {b} is not a multiple of stop_width {stop_width}")
    per = b // stop_width
    if per & (per - 1):
        raise ValueError(f"tree width {per} is not a power of two")


def key_bits(bottom_depths: tuple[int, ...], levels: int, depth_offset: int = 0) -> int:
    """tree_layers' key bits: bit j set where the compression at depth
    depth_offset + j takes the bottom-layer key 1 (tree_reduce_layers)."""
    return sum(1 << j for j in range(levels) if depth_offset + j in bottom_depths)


def tree_reduce_layers(
    leaves_mont: torch.Tensor,
    bottom_depths: tuple[int, ...],
    stop_width: int = 1,
    depth_offset: int = 0,
) -> list[torch.Tensor]:
    """Power-of-two Merkle reduction, keeping every layer (bottom first).

    leaves_mont: (NL, B), B a power of two (per tree).  Compressions at the
    depths in `bottom_depths` use the bottom-layer key 1 (depth 0 for cell
    hashes, and again at the block-tree depth where block roots become the
    bottom layer of the slot tree), all others key 0; depths count from
    `depth_offset`.  `stop_width` > 1 reduces that many same-shaped trees
    lying side by side to one root each: pairs never cross a tree boundary
    because every tree's width is a power of two.
    """
    _check_width(leaves_mont.shape[1], stop_width)
    layers = [leaves_mont]
    d = depth_offset
    cur = leaves_mont
    while cur.shape[1] > stop_width:
        cur = compress_layer(cur[:, 0::2], cur[:, 1::2], 1 if d in bottom_depths else 0)
        layers.append(cur)
        d += 1
    return layers


def tree_reduce_general(leaves_mont: torch.Tensor) -> list[torch.Tensor]:
    """Full keyed Merkle build for any width >= 1, all layers kept.

    Equivalent of oracle.merkle.merkle_tree (Merkle.hs:69-83): an odd
    trailing node compresses against zero with the odd key (3 at the bottom,
    2 above); a singleton bottom still gets one bottom-odd compression.
    """
    return tree_reduce_general_many([leaves_mont])[0]


def tree_reduce_general_many(leaves_mont: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """tree_reduce_general of several trees of any widths: each level of
    all the trees still above their root is at most two compressions, one
    over every pair and one over every odd trailing node."""
    trees = [[x] for x in leaves_mont]
    bottom = True
    while True:
        live = [t for t in trees if t[-1].shape[1] > 1 or bottom]
        if not live:
            return trees
        halves = [t[-1].shape[1] // 2 for t in live]
        odds = [t[-1][:, 2 * h :] for t, h in zip(live, halves)]  # 0 or 1 node
        pairs = torch.cat([t[-1][:, : 2 * h] for t, h in zip(live, halves)], dim=1)
        odd = torch.cat(odds, dim=1)
        up = pairs[:, :0]
        if pairs.shape[1]:
            up = compress_layer(pairs[:, 0::2], pairs[:, 1::2], 1 if bottom else 0)
        odd_up = odd
        if odd.shape[1]:
            odd_up = compress_layer(odd, torch.zeros_like(odd), 3 if bottom else 2)
        for t, u, o in zip(live, up.split(halves, dim=1),
                           odd_up.split([o.shape[1] for o in odds], dim=1)):
            t.append(torch.cat([u, o], dim=1))
        bottom = False


def extract_paths_device(
    layers: list[torch.Tensor], indices: torch.Tensor, max_depth: int
) -> torch.Tensor:
    """Batched Merkle-path gather from a stored layer stack, on the layers'
    device.

    layers[d]: (NL, W >> d) with W a power of two (the flat cell -> block ->
    slot stack: the sibling of node j at depth d is node j^1,
    Slot.hs:181-187).  indices: (S,) leaf indices.  Returns
    (max_depth, NL, S) sibling planes, zero beyond the tree depth
    (types.nim:27-37 padding).
    """
    s = indices.shape[0]
    depth = len(layers) - 1
    idx = indices.to(layers[0].device, torch.int64)
    out = layers[0].new_zeros((max_depth, NL, s))
    for d in range(min(depth, max_depth)):
        if layers[d].shape[1] > 1:
            out[d] = layers[d].index_select(1, (idx >> d) ^ 1)
    return out


def from_mont_layers(layers: list[torch.Tensor]) -> list[torch.Tensor]:
    """Montgomery layers -> canonical, as one multiply over all of them."""
    canon = L.from_mont(torch.cat(layers, dim=1))
    return list(torch.split(canon, [lyr.shape[1] for lyr in layers], dim=1))


def slot_tree_from_hashes(
    hashes: torch.Tensor, block_tree_depth: int, n_groups: int = 1
) -> list[torch.Tensor]:
    """Montgomery cell hashes (NL, B) -> the layers of slot_tree_from_rows
    (the tree part of it: one subtree-kernel call)."""
    _check_width(hashes.shape[1], n_groups)
    levels = (hashes.shape[1] // n_groups).bit_length() - 1
    return tree_layers(hashes, levels, key_bits((0, block_tree_depth), levels), n_groups)


def slot_tree_from_rows(
    rows: torch.Tensor, block_tree_depth: int, n_groups: int = 1
) -> list[torch.Tensor]:
    """Cell byte rows (cell_size, B) -> all tree layers of the slot,
    canonical form.

    Bottom (cell hashes) first, per-tree root(s) last; layer
    block_tree_depth holds the block roots.  `n_groups` independent
    same-shaped slots may lie side by side on the batch axis.
    """
    return slot_tree_from_hashes(hash_cells_rows(rows), block_tree_depth, n_groups)


def slot_tree_from_felts(
    cells_felts: torch.Tensor, block_tree_depth: int, n_groups: int = 1
) -> list[torch.Tensor]:
    """Encoded cells (nfelts, NL, B) -> the layers of slot_tree_from_rows."""
    return slot_tree_from_hashes(hash_cells_mont(cells_felts), block_tree_depth, n_groups)
