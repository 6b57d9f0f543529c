"""Streaming (chunked) slot-tree construction with bounded memory, for
BN254 and Goldilocks.

Port of codex_storage_proofs_circuits_tpu/models/streaming.py.  Cells
stream through the device in chunks; each chunk is a complete, aligned
subtree of the slot tree (the chunk size divides n_cells, both powers of
two), so its digest layers are exact contiguous segments of the global
layer stack.  The device keeps only digest layers (64 B per node as int32
limb planes, about twice the leaf count in all) and one chunk's byte rows.

A fake-data chunk is one pass on the device, with no cell bytes crossing
from the host: seed bases (32 B) -> PRNG (kernel K3) -> (cell_size, B)
byte rows -> the cell hashes, straight from the rows (K2 for BN254, K6 for
Goldilocks: the byte encode, and for BN254 the Montgomery form, happen in
the kernel) -> the tree: one compression launch per layer for BN254 (K1),
two launches of the subtree kernel for a Goldilocks chunk (K4 for
Poseidon2-GL, K5 for Monolith).  File-backed data loads on the host,
crosses per chunk and is read in place as a (B, cell_size).T view.

Chunk-checkpoint resume is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import limbs as L
from ..ops.fake_prng import fake_seed_bases, gen_rows
from ..oracle.slot import SlotConfig
from . import data as D
from . import gl_hashing as GH
from . import hashing as H

# One thread per cell in the kernels.  With the byte encode in the hash
# kernels a chunk holds only its byte rows (512 MiB at 2^18 cells of 2048
# bytes) and its digest layers; a warm 1 GB slot root measured 13-23 %
# faster at 2^18 cells than at 2^16 on an H100 (tools_torch/chunk_sweep.py; the
# 2^16 launches leave most of each SM's room for resident warps empty), at a
# peak of 1.2 GiB.  The root and the layers do not depend on the chunk size.
DEFAULT_CHUNK_CELLS = 1 << 18


@dataclass
class StreamingStats:
    """Host wall-clock of a streaming build by stage.  Device work is
    asynchronous, so datagen/device time the dispatch; the final wait for
    the device falls in finalize_s."""

    datagen_s: float = 0.0
    device_s: float = 0.0
    finalize_s: float = 0.0
    chunks: int = 0
    cells: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _chunk_layers(cfg: SlotConfig, c: int, chunk_cells: int, device, st, tree):
    t0 = time.perf_counter()
    if cfg.data_src.kind == "fake":
        s1, s2 = fake_seed_bases(cfg.data_src.seed, c * chunk_cells, device)
        rows = gen_rows(s1, s2, cfg.cell_size, chunk_cells)  # (cell_size, B) u8
    else:
        cells = D.load_cells(cfg, np.arange(c * chunk_cells, (c + 1) * chunk_cells))
        rows = torch.from_numpy(cells).to(device).T
    t1 = time.perf_counter()
    layers = tree(rows)
    st.datagen_s += t1 - t0
    st.device_s += time.perf_counter() - t1
    st.chunks += 1
    st.cells += chunk_cells
    return layers


def _stream(cfg: SlotConfig, chunk_cells: int, stats, device, tree, tops):
    """The chunk loop shared by both fields.  tree(rows, btd): a chunk's
    layers from its (cell_size, B) byte rows; tops(chunk roots, btd, chunk
    depth): the layers above the chunks.  Layers concatenate on their last
    axis."""
    n_cells = cfg.n_cells
    btd = cfg.cells_per_block.bit_length() - 1
    chunk_cells = min(chunk_cells, n_cells)
    if n_cells <= cfg.cells_per_block:
        raise ValueError("streaming needs a multi-block slot")
    if chunk_cells & (chunk_cells - 1) or n_cells % chunk_cells:
        raise ValueError(f"chunk of {chunk_cells} cells does not tile {n_cells} cells")
    n_chunks = n_cells // chunk_cells
    chunk_depth = chunk_cells.bit_length() - 1
    st = stats if stats is not None else StreamingStats()

    segments: list[list[torch.Tensor]] = [[] for _ in range(chunk_depth + 1)]
    for c in range(n_chunks):
        layers = _chunk_layers(cfg, c, chunk_cells, device, st, lambda rows: tree(rows, btd))
        for d, lyr in enumerate(layers):
            segments[d].append(lyr)

    t0 = time.perf_counter()
    out = [torch.cat(seg, dim=-1) for seg in segments]
    if n_chunks > 1:
        # reduce the chunk roots; keys follow the global depth schedule
        out.extend(tops(out[-1], btd, chunk_depth))
    if out[-1].device.type == "cuda":
        torch.cuda.synchronize(out[-1].device)
    st.finalize_s += time.perf_counter() - t0
    return out


def streaming_slot_layers(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> list[torch.Tensor]:
    """Full BN254 slot-tree layer stack (canonical int32 limb planes), in
    chunks.

    Returns layers[d] of shape (NL, n_cells >> d): layers[0] the cell
    hashes, layers[-1] the (NL, 1) slot root, identical to
    H.slot_tree_from_rows over all cells at once.
    """

    def tops(roots, btd, chunk_depth):
        layers = H.tree_reduce_layers(
            L.to_mont(roots), bottom_depths=(0, btd), depth_offset=chunk_depth
        )
        return H.from_mont_layers(layers[1:])

    return _stream(cfg, chunk_cells, stats, device, H.slot_tree_from_rows, tops)


def streaming_slot_root(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> int:
    """BN254 slot root only (python int), via the chunked build."""
    return L.unpack(streaming_slot_layers(cfg, chunk_cells, stats, device)[-1])[0]


def streaming_slot_layers_gl(
    cfg: SlotConfig,
    hash_fun: str = "poseidon2",
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> list[torch.Tensor]:
    """Goldilocks slot-tree digest layer stack (canonical), in chunks.

    Returns layers[d] of shape (4, 4, n_cells >> d), identical to
    GH.slot_tree_from_rows_gl over all cells at once.
    """

    def tree(rows, btd):
        return GH.slot_tree_from_rows_gl(hash_fun, rows, btd)

    def tops(roots, btd, chunk_depth):
        return GH.gl_tree_reduce_layers(roots, hash_fun, (0, btd), depth_offset=chunk_depth)[1:]

    return _stream(cfg, chunk_cells, stats, device, tree, tops)


def streaming_slot_root_gl(
    cfg: SlotConfig,
    hash_fun: str = "poseidon2",
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> tuple[int, ...]:
    """Goldilocks slot root (a Digest tuple of python ints), via the
    chunked build."""
    return GH.digests(streaming_slot_layers_gl(cfg, hash_fun, chunk_cells, stats, device)[-1])[0]
