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
the kernel) -> the tree, by the subtree kernels (K1 for BN254; K4 for
Poseidon2-GL, K5 for Monolith: two launches a Goldilocks chunk).
File-backed data is read on the host, a chunk in parallel positioned reads
into one page-locked block (models/data.load_cells), crosses per chunk in
one synchronous copy and is read in place as a (B, cell_size).T view.

A BN254 chunk's layers stop at CHUNK_STOP_WIDTH nodes (one launch
of K1), and the joined frontier of all the chunks goes to the slot root in
one call of the subtree entry: the narrow levels, where a level waits on
one permutation's latency however few nodes it has, are paid once a slot
and not once a chunk.  Chunks are aligned power-of-two subtrees, so the
frontier is itself a power-of-two tree and its layers are the chunks'
layers concatenated.

A BN254 build can checkpoint each finished chunk's digest layers and
resume from them (ChunkCheckpoint, in the JAX package's on-disk format, so
a checkpoint written by either package resumes in the other); with a
checkpoint, chunks go to their chunk roots, as that format holds them.
Goldilocks builds have no checkpoint, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import convert
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
# Below about 2^14 compressions a BN254 level no longer fills the card (132
# SMs x 4 schedulers x 32 lanes) and takes one permutation's latency
# (tools_torch/p2_tree_widths.py, PERF.md): a chunk's layers stop at this
# width, and the levels above it are built once for the whole slot.
CHUNK_STOP_WIDTH = 1 << 14


# ---------------------------------------------------------------------------
# Checkpoint/resume of chunk subtree layers (BN254).


def _cfg_fingerprint(cfg: SlotConfig, chunk_cells: int) -> str:
    src = cfg.data_src
    key = json.dumps(
        [
            cfg.cell_size,
            cfg.block_size,
            cfg.n_cells,
            chunk_cells,
            src.kind,
            src.seed if src.kind == "fake" else src.filename,
        ]
    )
    return hashlib.sha256(key.encode()).hexdigest()[:16]


class ChunkCheckpoint:
    """Digest-layer checkpoint: one .npz per finished chunk and a manifest.

    The JAX package's format: `manifest.json` holds the fingerprint and the
    finished chunks, `chunk_%06d.npz` holds arrays `layer_%03d`, each a
    canonical (16, w) uint32 limb plane; both files are replaced
    atomically.  Only digests are stored, never cell bytes.  A manifest
    with another fingerprint (another slot or chunk size) starts clean.
    The port's layers are int32 limb planes: they convert here, at the
    file boundary.
    """

    def __init__(self, path: str, cfg: SlotConfig, chunk_cells: int):
        self.path = path
        self.fp = _cfg_fingerprint(cfg, chunk_cells)
        self.manifest_path = os.path.join(path, "manifest.json")
        os.makedirs(path, exist_ok=True)
        self.done: set[int] = set()
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    m = json.load(f)
                if m.get("fingerprint") == self.fp:
                    self.done = {
                        c for c in m.get("chunks", []) if os.path.exists(self._chunk_path(c))
                    }
            except (OSError, ValueError):
                pass

    def _chunk_path(self, c: int) -> str:
        return os.path.join(self.path, f"chunk_{c:06d}.npz")

    def load(self, c: int, device=None) -> list[torch.Tensor]:
        with np.load(self._chunk_path(c)) as z:
            return convert.layers_from_numpy([z[k] for k in sorted(z.files)], device)

    def save(self, c: int, layers: list[torch.Tensor]) -> None:
        tmp = self._chunk_path(c) + ".tmp"
        arrays = convert.layers_to_numpy(layers)
        with open(tmp, "wb") as f:  # a file handle: savez must not append .npz
            np.savez(f, **{f"layer_{d:03d}": x for d, x in enumerate(arrays)})
        os.replace(tmp, self._chunk_path(c))
        self.done.add(c)
        tmp_m = self.manifest_path + ".tmp"
        with open(tmp_m, "w") as f:
            json.dump({"fingerprint": self.fp, "chunks": sorted(self.done)}, f)
        os.replace(tmp_m, self.manifest_path)


@dataclass
class StreamingStats:
    """Host wall-clock of a streaming build by stage.  Device work is
    asynchronous, so datagen/device time the dispatch; the final wait for
    the device falls in finalize_s.  With a checkpoint, loaded counts the
    chunks read back (also counted in chunks), and save_s / load_s the
    seconds spent writing and reading chunk files (a save waits for its
    chunk's layers).  file_reads counts the reads of file-backed chunks
    (models/data.FILE_READS "bulk" and "cell": one a chunk), read_parts
    the positioned reads they were split into ("part"); on file data
    datagen_s is their read and the copy to the device, both synchronous."""

    datagen_s: float = 0.0
    device_s: float = 0.0
    finalize_s: float = 0.0
    chunks: int = 0
    cells: int = 0
    loaded: int = 0
    save_s: float = 0.0
    load_s: float = 0.0
    file_reads: int = 0
    read_parts: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _chunk_layers(cfg: SlotConfig, start: int, chunk_cells: int, device, st, tree):
    t0 = time.perf_counter()
    if cfg.data_src.kind == "fake":
        s1, s2 = fake_seed_bases(cfg.data_src.seed, start, device)
        rows = gen_rows(s1, s2, cfg.cell_size, chunk_cells)  # (cell_size, B) u8
    else:
        reads, parts = D.FILE_READS["bulk"] + D.FILE_READS["cell"], D.FILE_READS["part"]
        cells = D.load_cells(cfg, np.arange(start, start + chunk_cells))
        st.file_reads += D.FILE_READS["bulk"] + D.FILE_READS["cell"] - reads
        st.read_parts += D.FILE_READS["part"] - parts
        # synchronous: the next chunk's read may reuse the host block
        rows = torch.from_numpy(cells).to(device).T
    t1 = time.perf_counter()
    layers = tree(rows)
    st.datagen_s += t1 - t0
    st.device_s += time.perf_counter() - t1
    st.chunks += 1
    st.cells += chunk_cells
    return layers


def stream_range(cfg: SlotConfig, start: int, n: int, chunk_cells: int, stats, device,
                 tree, tops, ckpt: ChunkCheckpoint | None = None,
                 stop_after_chunks: int | None = None) -> list[torch.Tensor] | None:
    """The chunk loop shared by both fields, over cells start..start+n-1 of
    a slot (n a power of two, start a multiple of n): the layers of that
    aligned subtree, its root last.  tree(rows, btd): a chunk's layers from
    its (cell_size, B) byte rows, to its root or to a width every chunk
    stops at; tops(frontier, btd, depth): the layers above the chunks'
    joined last layer, which lies at that depth.  Layers concatenate on
    their last axis.  With ckpt, finished chunks are read back and new ones
    saved; with stop_after_chunks, the build returns None once that many
    chunks were newly computed."""
    btd = cfg.cells_per_block.bit_length() - 1
    chunk_cells = min(chunk_cells, n)
    if n & (n - 1) or start % n or chunk_cells & (chunk_cells - 1) or n % chunk_cells:
        raise ValueError(f"chunks of {chunk_cells} cells do not tile cells {start}..+{n}")
    n_chunks = n // chunk_cells
    st = stats if stats is not None else StreamingStats()

    segments: list[list[torch.Tensor]] = []
    new_chunks = 0
    for c in range(n_chunks):
        if ckpt is not None and c in ckpt.done:
            t0 = time.perf_counter()
            layers = ckpt.load(c, device)
            st.load_s += time.perf_counter() - t0
            st.loaded += 1
            st.chunks += 1
            st.cells += chunk_cells
        else:
            if stop_after_chunks is not None and new_chunks >= stop_after_chunks:
                return None
            layers = _chunk_layers(cfg, start + c * chunk_cells, chunk_cells, device, st,
                                   lambda rows: tree(rows, btd))
            new_chunks += 1
            if ckpt is not None:
                t0 = time.perf_counter()
                ckpt.save(c, layers)
                st.save_s += time.perf_counter() - t0
        if not segments:
            segments = [[] for _ in layers]
        if len(layers) != len(segments):
            raise ValueError("the chunks' layer stacks differ in depth")
        for d, lyr in enumerate(layers):
            segments[d].append(lyr)

    t0 = time.perf_counter()
    out = [torch.cat(seg, dim=-1) for seg in segments]
    if out[-1].shape[-1] > 1:
        # reduce the joined frontier; keys follow the global depth schedule
        out.extend(tops(out[-1], btd, len(out) - 1))
    if out[-1].device.type == "cuda":
        torch.cuda.synchronize(out[-1].device)
    st.finalize_s += time.perf_counter() - t0
    return out


def _full_slot(cfg: SlotConfig, chunk_cells: int) -> int:
    if cfg.n_cells <= cfg.cells_per_block:
        raise ValueError("streaming needs a multi-block slot")
    return min(chunk_cells, cfg.n_cells)


def bn254_tops(roots: torch.Tensor, btd: int, depth: int) -> list[torch.Tensor]:
    """The BN254 layers above a power-of-two row of canonical subtree roots
    at tree depth `depth` (their own layer excluded), canonical."""
    levels = roots.shape[1].bit_length() - 1
    return H.tree_layers(roots, levels, H.key_bits((0, btd), levels, depth), mont=False)[1:]


def bn254_chunk_tree(hashes: torch.Tensor, btd: int) -> list[torch.Tensor]:
    """A BN254 chunk's layers from its (NL, B) Montgomery cell hashes, down
    to CHUNK_STOP_WIDTH nodes (its root when the chunk is no wider)."""
    trees = CHUNK_STOP_WIDTH if hashes.shape[1] > CHUNK_STOP_WIDTH else 1
    return H.slot_tree_from_hashes(hashes, btd, n_groups=trees)


def bn254_rows_tree(rows: torch.Tensor, btd: int) -> list[torch.Tensor]:
    """A BN254 chunk's layers from its byte rows: the cell hashes (K2), then
    bn254_chunk_tree."""
    return bn254_chunk_tree(H.hash_cells_rows(rows), btd)


def gl_tops(hash_fun: str):
    """The Goldilocks twin of bn254_tops for one hash."""

    def tops(roots: torch.Tensor, btd: int, depth: int) -> list[torch.Tensor]:
        return GH.gl_tree_reduce_layers(roots, hash_fun, (0, btd), depth_offset=depth)[1:]

    return tops


def gl_rows_tree(hash_fun: str):
    """A Goldilocks chunk's layers from its byte rows, for one hash."""

    def tree(rows: torch.Tensor, btd: int) -> list[torch.Tensor]:
        return GH.slot_tree_from_rows_gl(hash_fun, rows, btd)

    return tree


def streaming_slot_layers(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
    checkpoint_dir: str | None = None,
    stop_after_chunks: int | None = None,
) -> list[torch.Tensor] | None:
    """Full BN254 slot-tree layer stack (canonical int32 limb planes), in
    chunks.

    Returns layers[d] of shape (NL, n_cells >> d): layers[0] the cell
    hashes, layers[-1] the (NL, 1) slot root, identical to
    H.slot_tree_from_rows over all cells at once.

    checkpoint_dir: save each finished chunk's digest layers there and
    resume any matching earlier build (ChunkCheckpoint).  stop_after_chunks:
    stop after that many newly computed chunks and return None (to test
    resume, or to yield to a scheduler).  Without a checkpoint a chunk's
    layers stop at CHUNK_STOP_WIDTH nodes, and the layers above are built
    from all the chunks at once.
    """
    chunk_cells = _full_slot(cfg, chunk_cells)
    ckpt = ChunkCheckpoint(checkpoint_dir, cfg, chunk_cells) if checkpoint_dir else None
    tree = H.slot_tree_from_rows if ckpt else bn254_rows_tree
    return stream_range(cfg, 0, cfg.n_cells, chunk_cells, stats, device,
                        tree, bn254_tops, ckpt, stop_after_chunks)


def streaming_slot_root(
    cfg: SlotConfig,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    stats: StreamingStats | None = None,
    device="cuda",
    checkpoint_dir: str | None = None,
    stop_after_chunks: int | None = None,
) -> int | None:
    """BN254 slot root only (python int), via the chunked build; None if
    the build stopped early (stop_after_chunks)."""
    layers = streaming_slot_layers(cfg, chunk_cells, stats, device, checkpoint_dir,
                                   stop_after_chunks)
    return None if layers is None else L.unpack(layers[-1])[0]


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
    chunk_cells = _full_slot(cfg, chunk_cells)
    return stream_range(cfg, 0, cfg.n_cells, chunk_cells, stats, device,
                        gl_rows_tree(hash_fun), gl_tops(hash_fun))


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
