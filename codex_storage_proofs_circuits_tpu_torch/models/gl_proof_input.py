"""Goldilocks proof-input generation on the device.

Port of codex_storage_proofs_circuits_tpu/models/gl_proof_input.py, the GL
twin of models/proof_input.py.  Same contract as
oracle.goldilocks_pipeline.generate_proof_input_gl
(gen_input/goldilocks.nim:22-87), with every slot's cell sponges and tree
layers built on the device (models/gl_hashing.py, models/streaming.py).
After the slot roots:

  * the dataset tree over the slot roots and the slot's proof are a few
    compressions and stay on the host;
  * sampling runs on the device: one sponge launch (K6's felts entry)
    digests [entropy | root | intToDigest(counter)] for every counter
    (gl_hashing.sample_indices_gl, shared with the sharded proof input),
    and the indices come back in one copy;
  * the sampled cells' bytes come from one models/data.load_cells call,
    and their felts from one encode on the device (ops/gl_encode);
  * the sampled paths come from the slot's layers (one gather on the device
    in the streaming path, the oracle's trees in the batched one).

Each of the four stages runs in a torch.profiler span, cspc.proof_gl.slots,
.sample, .cells and .paths; a ProofStatsGL, when given, adds up their
host-clock seconds and counts the samples and the cell loads.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..oracle.dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks import Digest, compress_fn
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from ..oracle.merkle import extract_proof, merkle_tree
from . import data as D
from . import gl_hashing as GH
from .streaming import DEFAULT_CHUNK_CELLS, streaming_slot_layers_gl

SPAN = "cspc.proof_gl."


@dataclass
class ProofStatsGL:
    """Host wall-clock of GL proof inputs by stage, summed over calls.
    slots_s: every slot's tree, the roots to the host, the dataset tree and
    the slot's proof; sample_s: the sampler, to its indices on the host;
    cells_s: the sampled cells' bytes and their felts, to the host;
    paths_s: the sampled paths, to their digests on the host.  Each stage
    ends in its own copy to the host, so its device work falls in it.
    samples counts the sampled cells, cell_loads the models/data.load_cells
    calls that read them, cell_bytes their bytes."""

    slots_s: float = 0.0
    sample_s: float = 0.0
    cells_s: float = 0.0
    paths_s: float = 0.0
    samples: int = 0
    cell_loads: int = 0
    cell_bytes: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@contextmanager
def _stage(stats: ProofStatsGL | None, name: str):
    """The span cspc.proof_gl.<name>, and its seconds added to stats."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(SPAN + name):
        yield
    if stats is not None:
        key = f"{name}_s"
        setattr(stats, key, getattr(stats, key) + time.perf_counter() - t0)


def _cell_digests(cells: np.ndarray, device) -> list[list[Digest]]:
    """(B, cell_size) cell bytes -> each cell's felts as digests
    (oracle.goldilocks.bytes_to_digests_gl), encoded on the device
    (ops/gl_encode) and brought to the host in one copy."""
    felts = GH.encode_cells_gl(cells, device)  # (nfelts, 4, B)
    nd, b = felts.shape[0] // GH.FELTS_PER_DIGEST, felts.shape[2]
    cols = felts.reshape(nd, GH.FELTS_PER_DIGEST, GH.NL, b).permute(1, 2, 3, 0)
    flat = GH.digests(cols.reshape(GH.FELTS_PER_DIGEST, GH.NL, b * nd))  # cell-major
    return [flat[k * nd:(k + 1) * nd] for k in range(b)]


def _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, build_slots, device, stats):
    """The shared tail: dataset tree, sampling, cell data, paths.
    build_slots() builds every slot's tree and returns the slot roots
    (Digests) and merkle_paths_of(idxs)."""
    with _stage(stats, "slots"):
        roots, merkle_paths_of = build_slots()
        dset_tree = merkle_tree(roots, compress_fn(hash_fun))
        slot_proof = extract_proof(dset_tree, slot_index)
    our_root = roots[slot_index]
    with _stage(stats, "sample"):
        root = GH.digest_planes(our_root, device)
        idxs = GH.sample_indices_gl(hash_fun, entropy, root, dset.n_samples,
                                    (dset.n_cells - 1).bit_length()).tolist()
    with _stage(stats, "cells"):
        cells = D.load_cells(slot_cfg_from_dataset_cfg(glob, dset, slot_index), np.asarray(idxs))
        cell_data = _cell_digests(cells, device)
    with _stage(stats, "paths"):
        merkle_paths = merkle_paths_of(idxs)
    if stats is not None:
        stats.samples += len(idxs)
        stats.cell_loads += 1
        stats.cell_bytes += cells.nbytes
    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )


def generate_proof_input_gl(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
    device="cuda",
    stats: ProofStatsGL | None = None,
) -> ProofInputGL:
    """All slots' trees in one batched device build (every cell of every
    slot is loaded on the host first: for small slots)."""

    def build_slots():
        slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
        trees = GH.build_slot_trees_gl(hash_fun, slot_cfgs, device)
        our_tree = trees[slot_index]
        k = slot_cfgs[slot_index].cells_per_block

        def merkle_paths_of(idxs):
            paths = []
            for idx in idxs:
                block_idx, within = divmod(idx, k)
                bot = extract_proof(our_tree.mini_trees[block_idx], within)
                top = extract_proof(our_tree.big_tree, block_idx)
                paths.append(_pad_digest_path(bot.merkle_path + top.merkle_path, glob.max_depth))
            return paths

        return [t.root for t in trees], merkle_paths_of

    return _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, build_slots, device, stats)


def generate_proof_input_gl_streaming(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    device="cuda",
    stats: ProofStatsGL | None = None,
) -> ProofInputGL:
    """Large-slot path: one streaming chunked build per slot and one batched
    gather of the sampled paths on the device.  Slots other than the
    sampled one keep only their root."""

    def build_slots():
        roots: list[Digest] = []
        our_layers = None
        for i in range(dset.n_slots):
            cfg = slot_cfg_from_dataset_cfg(glob, dset, i)
            layers = streaming_slot_layers_gl(cfg, hash_fun, chunk_cells, device=device)
            roots.append(GH.digests(layers[-1])[0])
            if i == slot_index:
                our_layers = layers

        def merkle_paths_of(idxs):
            paths = GH.extract_gl_paths_device(
                our_layers, torch.tensor(idxs, dtype=torch.int64), glob.max_depth
            ).cpu()  # (max_depth, 4, 4, S)
            per_depth = [GH.digests(paths[d]) for d in range(glob.max_depth)]
            return [[per_depth[d][s] for d in range(glob.max_depth)] for s in range(len(idxs))]

        return roots, merkle_paths_of

    return _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, build_slots, device, stats)
