"""Streaming (chunked) slot-tree construction with bounded memory, BN254.

Port of the BN254 half of codex_storage_proofs_circuits_tpu/models/
streaming.py.  Cells stream through the device in chunks; each chunk is a
complete, aligned subtree of the slot tree (the chunk size divides n_cells,
both powers of two), so its digest layers are exact contiguous segments of
the global layer stack.  The device keeps only digest layers (64 B per node
as int32 limb planes, about twice the leaf count in all).

A fake-data chunk is one pass on the device, with no cell bytes crossing
from the host: seed bases (32 B) -> PRNG (kernel K3) -> byte pad + felt
encode -> Montgomery form -> rate-2 sponge (K2) -> one compression per layer
(K1).  File-backed data loads on the host and crosses per chunk.

Chunk-checkpoint resume and the Goldilocks half are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from codex_storage_proofs_circuits_tpu.models import data as D
from codex_storage_proofs_circuits_tpu.oracle.slot import SlotConfig

from ..ops import limbs as L
from ..ops.encode import encode_cells, encode_rows
from ..ops.fake_prng import fake_seed_bases, gen_rows
from . import hashing as H

# One thread per cell in the kernels: 2^16 cells fill the card's 132 SMs
# where the JAX package's 2^13 left most of them idle.  The root and the
# layers do not depend on the chunk size.
DEFAULT_CHUNK_CELLS = 1 << 16


@dataclass
class StreamingStats:
    """Host wall-clock of a streaming build by stage.  Device work is
    asynchronous, so datagen/encode/device time the dispatch; the final
    wait for the device falls in finalize_s."""

    datagen_s: float = 0.0
    encode_s: float = 0.0
    device_s: float = 0.0
    finalize_s: float = 0.0
    chunks: int = 0
    cells: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _chunk_layers(cfg: SlotConfig, c: int, chunk_cells: int, btd: int, device, st):
    t0 = time.perf_counter()
    if cfg.data_src.kind == "fake":
        s1, s2 = fake_seed_bases(cfg.data_src.seed, c * chunk_cells, device)
        rows = gen_rows(s1, s2, cfg.cell_size, chunk_cells)  # (cell_size, B) u8
        t1 = time.perf_counter()
        felts = encode_rows(rows)
    else:
        cells = D.load_cells(cfg, np.arange(c * chunk_cells, (c + 1) * chunk_cells))
        t1 = time.perf_counter()
        felts = encode_cells(torch.from_numpy(cells).to(device))
    t2 = time.perf_counter()
    layers = H.slot_tree_from_felts(felts, btd)
    st.datagen_s += t1 - t0
    st.encode_s += t2 - t1
    st.device_s += time.perf_counter() - t2
    st.chunks += 1
    st.cells += chunk_cells
    return layers


def streaming_slot_layers(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> list[torch.Tensor]:
    """Full slot-tree layer stack (canonical int32 limb planes), in chunks.

    Returns layers[d] of shape (NL, n_cells >> d): layers[0] the cell
    hashes, layers[-1] the (NL, 1) slot root, identical to
    H.slot_tree_from_felts over all cells at once.
    """
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
        for d, lyr in enumerate(_chunk_layers(cfg, c, chunk_cells, btd, device, st)):
            segments[d].append(lyr)

    t0 = time.perf_counter()
    out = [torch.cat(seg, dim=1) for seg in segments]
    if n_chunks > 1:
        # reduce the chunk roots; keys follow the global depth schedule
        tops = H.tree_reduce_layers(
            L.to_mont(out[-1]), bottom_depths=(0, btd), depth_offset=chunk_depth
        )
        out.extend(H.from_mont_layers(tops[1:]))
    if out[-1].device.type == "cuda":
        torch.cuda.synchronize(out[-1].device)
    st.finalize_s += time.perf_counter() - t0
    return out


def streaming_slot_root(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
) -> int:
    """Slot root only (python int), via the chunked build."""
    return L.unpack(streaming_slot_layers(cfg, chunk_cells, stats, device)[-1])[0]
