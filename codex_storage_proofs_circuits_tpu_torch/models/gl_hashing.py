"""Batched Goldilocks pipeline: cell encode -> digests -> Merkle trees.

Port of codex_storage_proofs_circuits_tpu/models/gl_hashing.py and of the
two single-device reducers of parallel/gl_tree.py (gl_tree_reduce_layers,
gl_tree_reduce_general), the GL twins of models/hashing.py.  One rate-8
sponge launch (kernel K6) digests every cell of a batch straight from its
byte rows (the byte encode happens in the kernel), and the subtree kernel
(K4 for Poseidon2-GL, K5 for Monolith) makes the Merkle layers above them,
many layers a launch; the odd-width dataset tree (gl_tree_reduce_general)
runs one keyed compression launch a layer.  The proof inputs' pieces:
batched_slot_layers_gl, the flat layer stacks of small slots built in one
batch (the twin of models/streaming.streaming_slot_layers_gl for large
ones); sample_indices_gl, the cell sampler (one sponge launch, K6's felts
entry, for every counter), which every GL proof input calls; cell_digests,
the sampled cells' felts encoded on the device; and paths_to_host_gl, the
one conversion to the host of the paths that models/hashing.py's
extract_paths_device gathers on the device for either field.
Digest layers are (4, 4, W) int32 limb planes (lane, limb, node).  The
felt entry points (sponge_digests, slot_tree_from_felts_gl) are the JAX
package's API, kept for the parity tests.

The JAX twin's TPU machinery is not carried over: the Pallas tile minimum
(_PALLAS_MIN_BATCH) and the lane padding up to it; the kernels take any
width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.goldilocks import Digest
from ..oracle.slot import SlotConfig
from ..ops import gl_encode
from ..ops import goldilocks_cuda as GC
from ..ops import goldilocks_plain as GP
from . import hashing as H

NL = 4  # 16-bit limbs per felt
FELTS_PER_DIGEST = 4


def sponge_digests(hash_fun: str, felts: torch.Tensor) -> torch.Tensor:
    """(n, 4, B) felts -> (4, 4, B) digests (K6 on a CUDA tensor)."""
    return GC.sponge_digest_felts(felts, hash_fun)


def sponge_digests_rows(hash_fun: str, rows: torch.Tensor) -> torch.Tensor:
    """(cell_size, B) uint8 byte rows -> (4, 4, B) digests (K6 on a CUDA
    tensor)."""
    return GC.sponge_digest_rows(rows, hash_fun)


def compress_digests(hash_fun: str, key: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Keyed digest compression (K4 / K5 on CUDA tensors)."""
    return GC.compress(x, y, key, hash_fun)


def encode_cells_gl(cells_u8: np.ndarray, device=None) -> torch.Tensor:
    """(B, cell_size) raw bytes -> (nfelts, 4, B) felt limb planes on device."""
    return gl_encode.encode_cells(torch.from_numpy(np.ascontiguousarray(cells_u8)).to(device))


def gl_tree_reduce_layers(
    digests: torch.Tensor,
    hash_fun: str,
    bottom_depths: tuple[int, ...],
    depth_offset: int = 0,
    stop_width: int = 1,
) -> list[torch.Tensor]:
    """Power-of-two keyed reduction of a (4, 4, W) digest layer, keeping
    every layer (bottom first).  Compressions at the depths in
    `bottom_depths` (counted from `depth_offset`) use key 1, all others
    key 0.  `stop_width` > 1 reduces that many same-shaped trees lying side
    by side to one root each.  The subtree kernel makes the layers (on a
    CUDA tensor: a 2^18-digest chunk in two launches)."""
    w = digests.shape[2]
    per = w // stop_width if stop_width >= 1 and w % stop_width == 0 else 0
    if per < 1 or per & (per - 1):
        raise ValueError(f"width {w} is not {stop_width} power-of-two trees")
    levels = per.bit_length() - 1
    key_bits = sum(1 << j for j in range(levels) if depth_offset + j in bottom_depths)
    return [digests, *GC.tree_layers(digests, hash_fun, levels, key_bits, stop_width)]


def gl_tree_reduce_general(leaves: torch.Tensor, hash_fun: str) -> list[torch.Tensor]:
    """Keyed Merkle build over digests for any width >= 1 (oracle.merkle
    merkle_tree semantics): an odd trailing node compresses against the zero
    digest with the odd key (3 at the bottom, 2 above); a singleton bottom
    still gets one bottom-odd compression."""
    layers = [leaves]
    bottom = True
    while layers[-1].shape[2] > 1 or bottom:
        cur = layers[-1]
        w = cur.shape[2]
        half = w // 2
        parts = []
        if half:
            parts.append(compress_digests(hash_fun, 1 if bottom else 0,
                                          cur[:, :, 0 : 2 * half : 2], cur[:, :, 1 : 2 * half : 2]))
        if w % 2 == 1:
            zero = cur.new_zeros((FELTS_PER_DIGEST, NL, 1))
            parts.append(compress_digests(hash_fun, 3 if bottom else 2, cur[:, :, w - 1 : w], zero))
        layers.append(torch.cat(parts, dim=2))
        bottom = False
    return layers


def slot_tree_from_rows_gl(
    hash_fun: str, rows: torch.Tensor, block_tree_depth: int, n_groups: int = 1
) -> list[torch.Tensor]:
    """Cell byte rows -> all flat tree layers (cell digests first, roots last).

    rows: (cell_size, B); layer d has shape (4, 4, B >> d).  Key 1 at depth
    0 and at block_tree_depth (the flat cell -> block -> slot stack).
    `n_groups` same-shaped slots may lie side by side on the batch axis.
    """
    return gl_tree_reduce_layers(
        sponge_digests_rows(hash_fun, rows), hash_fun, (0, block_tree_depth),
        stop_width=n_groups,
    )


def slot_tree_from_felts_gl(
    hash_fun: str, cells_felts: torch.Tensor, block_tree_depth: int, n_groups: int = 1
) -> list[torch.Tensor]:
    """Encoded cells (nfelts, 4, B) -> the layers of slot_tree_from_rows_gl."""
    return gl_tree_reduce_layers(
        sponge_digests(hash_fun, cells_felts), hash_fun, (0, block_tree_depth),
        stop_width=n_groups,
    )


def digests(layer: torch.Tensor) -> list[tuple[int, ...]]:
    """(4, 4, W) limb planes -> W Digest tuples of python ints.  Four
    lists and W tuples, no list a digest: the collector stops tracking a
    tuple of ints, so a proof's digests leave it no long-lived objects."""
    arr = layer.detach().cpu().numpy().astype(np.uint64)
    vals = arr[:, 0]
    for k in range(1, NL):
        vals = vals | (arr[:, k] << np.uint64(16 * k))
    return list(zip(*vals.tolist()))


def digest_planes(d: Digest, device) -> torch.Tensor:
    """A Digest -> (4 felts, 4 limbs, 1) planes."""
    return GP.pack(d, device).T.unsqueeze(-1).contiguous()


def sample_indices_gl(hash_fun: str, entropy: Digest, root: torch.Tensor, n_samples: int,
                      log2n: int) -> torch.Tensor:
    """Goldilocks cell indices of counters 1..n_samples, on the root's
    device: the low log2n bits of lane 0 of the rate-8 digest of
    [entropy | root | intToDigest(counter)] (sample/goldilocks.nim:18-38).
    root: (4, 4, 1) canonical digest."""
    if log2n > 32:
        raise ValueError(f"log2 nCells {log2n} > 32")
    dev, s = root.device, n_samples
    felts = torch.cat([
        digest_planes(entropy, dev).expand(4, GP.NL, s),
        root.expand(4, GP.NL, s),
        GP.pack(range(1, s + 1), dev).unsqueeze(0),
        torch.zeros((3, GP.NL, s), dtype=torch.int32, device=dev),
    ])  # (12, 4, S)
    h = sponge_digests(hash_fun, felts).to(torch.int64)
    return (h[0, 0] | (h[0, 1] << 16)) & ((1 << log2n) - 1)


def batched_slot_layers_gl(hash_fun: str, cfgs: list[SlotConfig], device
                           ) -> list[list[torch.Tensor]]:
    """The flat digest layer stacks (cell digests first, the slot root
    last) of identically shaped slots, built in one batch: every cell of
    every slot is loaded on the host first, so this is for small slots.
    Each slot's stack is slices of the batch's layers.  A single-block
    slot's stack ends in one more layer of width 1, the bottom-odd
    compression of its one block root (gl_tree_reduce_general)."""
    rows = H.slot_rows(cfgs, device)
    n, cfg0 = len(cfgs), cfgs[0]
    layers = slot_tree_from_rows_gl(hash_fun, rows, cfg0.cells_per_block.bit_length() - 1, n)
    stacks = [list(st) for st in zip(*(lyr.tensor_split(n, dim=2) for lyr in layers))]
    if cfg0.n_cells == cfg0.cells_per_block:
        for st in stacks:
            st.append(gl_tree_reduce_general(st[-1], hash_fun)[-1])
    return stacks


def cell_digests(cells: np.ndarray, device) -> list[list[Digest]]:
    """(B, cell_size) cell bytes -> each cell's felts as digests
    (oracle.goldilocks.bytes_to_digests_gl), encoded on the device
    (ops/gl_encode) and brought to the host in one copy."""
    felts = encode_cells_gl(cells, device)  # (nfelts, 4, B)
    nd, b = felts.shape[0] // FELTS_PER_DIGEST, felts.shape[2]
    cols = felts.reshape(nd, FELTS_PER_DIGEST, NL, b).permute(1, 2, 3, 0)
    flat = digests(cols.reshape(FELTS_PER_DIGEST, NL, b * nd))  # cell-major
    return [flat[k * nd:(k + 1) * nd] for k in range(b)]


def paths_to_host_gl(paths: torch.Tensor) -> list[list[Digest]]:
    """(max_depth, 4, 4, S) gathered sibling digests -> S paths of
    max_depth Digests, in one copy and one digests call."""
    depth, s = paths.shape[0], paths.shape[3]
    flat = digests(paths.permute(1, 2, 3, 0).reshape(FELTS_PER_DIGEST, NL, s * depth))
    return [flat[k * depth:(k + 1) * depth] for k in range(s)]
