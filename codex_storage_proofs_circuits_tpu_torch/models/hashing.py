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

The proof inputs' pieces live here too: batched_slot_layers, the flat
layer stacks of small slots built in one batch (the twin of
models/streaming.streaming_slot_layers for large ones); sample_indices,
the cell sampler (two K1 permutations for every counter), which every
BN254 proof input calls; and the path gather on the device
(extract_paths_device) with its one conversion to the host (paths_to_host).

The JAX twin's TPU machinery is not carried over: the 512-lane padding of
the Pallas tile (the CUDA kernels take any width), and the fixed-width
scan over the narrow tail layers (it bounded XLA compile time; here a
plain per-layer loop runs each layer as it is).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bn254
from ..ops import limbs as L
from ..ops import poseidon2_cuda as P2C
from ..ops import poseidon2_plain as P2
from ..ops.poseidon2_plain import pad_felts_rate2, to_mont_stack
from ..oracle.slot import SlotConfig
from . import data as D

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
    device, for either field (the Goldilocks proof inputs gather with it too).

    layers[d]: node + (W >> d,), node (NL,) for BN254 or (4, 4) for
    Goldilocks, W a power of two (the flat cell -> block -> slot stack: the
    sibling of node j at depth d is node j^1, Slot.hs:181-187).  indices:
    (S,) leaf indices.  Returns (max_depth,) + node + (S,) siblings, zero
    beyond the tree depth (types.nim:27-37 padding) and at a layer of width
    1 (a single-block slot's bottom-odd compression).
    """
    s = indices.shape[0]
    depth = len(layers) - 1
    idx = indices.to(layers[0].device, torch.int64)
    out = layers[0].new_zeros((max_depth,) + layers[0].shape[:-1] + (s,))
    for d in range(min(depth, max_depth)):
        if layers[d].shape[-1] > 1:
            out[d] = layers[d].index_select(-1, (idx >> d) ^ 1)
    return out


def paths_to_host(paths: torch.Tensor) -> list[list[int]]:
    """(max_depth, NL, S) gathered sibling planes -> S paths of max_depth
    canonical felts, in one copy and one unpack."""
    depth, _, s = paths.shape
    flat = L.unpack(paths.permute(1, 2, 0).reshape(NL, s * depth))  # sample-major
    return [flat[k * depth:(k + 1) * depth] for k in range(s)]


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


def slot_rows(cfgs: list[SlotConfig], device) -> torch.Tensor:
    """The byte rows (cell_size, n_slots * n_cells) of identically shaped
    slots on device, slot after slot, read in place: every cell is loaded
    on the host first, so this is for small slots (batched_slot_layers(_gl))."""
    if not cfgs:
        raise ValueError("slot_rows: no slots")
    shape0 = (cfgs[0].cell_size, cfgs[0].block_size, cfgs[0].n_cells)
    if any((c.cell_size, c.block_size, c.n_cells) != shape0 for c in cfgs):
        raise ValueError("slot_rows: slots must be identically shaped")
    return torch.from_numpy(np.concatenate([D.load_slot_cells(c) for c in cfgs])).to(device).T


def batched_slot_layers(cfgs: list[SlotConfig], device) -> list[list[torch.Tensor]]:
    """The canonical flat layer stacks (cell hashes first, the slot root
    last) of identically shaped slots, built in one batch: every cell of
    every slot is loaded on the host first, so this is for small slots.
    Each slot's stack is slices of the batch's layers.  A single-block
    slot's stack ends in one more layer of width 1: the oracle's tree over
    its one block root is a singleton bottom, which still gets one
    bottom-odd compression (tree_reduce_general; Merkle.hs:71-74)."""
    rows = slot_rows(cfgs, device)
    n, cfg0 = len(cfgs), cfgs[0]
    layers = slot_tree_from_rows(rows, cfg0.cells_per_block.bit_length() - 1, n_groups=n)
    stacks = [list(st) for st in zip(*(lyr.tensor_split(n, dim=1) for lyr in layers))]
    if cfg0.n_cells == cfg0.cells_per_block:
        for st in stacks:
            st.append(L.from_mont(tree_reduce_general(L.to_mont(st[-1]))[-1]))
    return stacks


def sample_indices(entropy: int, root: torch.Tensor, n_samples: int, log2n: int) -> torch.Tensor:
    """BN254 cell indices of counters 1..n_samples, on the root's device.

    root: (NL, 1) canonical slot root.  Index = low log2n bits of the
    canonical sponge2([entropy, root, counter]) (extractLowBits,
    types/bn254.nim:47-59): the first permutation does not depend on the
    counter, so it runs once, and one batched permutation spans the
    counters."""
    if log2n > 32:
        raise ValueError(f"log2 nCells {log2n} > 32")
    dev = root.device
    ent = L.pack([bn254.to_mont(entropy)], dev)
    counters = L.pack([bn254.to_mont(c) for c in range(1, n_samples + 1)], dev)
    iv = P2.SPONGE2_IV_MONT.to(dev, torch.int32)
    st1 = permute(torch.stack([ent, L.to_mont(root), iv]))  # (3, NL, 1)
    one = P2.ONE_MONT.to(dev, torch.int32)  # the `10*` padding felt
    s = n_samples
    x = L.add_mod(st1[0].expand(NL, s), counters)
    y = L.add_mod(st1[1], one).expand(NL, s)
    h = L.from_mont(permute(torch.stack([x, y, st1[2].expand(NL, s)]))[0]).to(torch.int64)
    return (h[0] | (h[1] << 16)) & ((1 << log2n) - 1)
