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
    and their felts from one encode on the device (gl_hashing.cell_digests);
  * the sampled paths are one gather from the sampled slot's flat layer
    stack on the device, brought to the host in one copy
    (gl_hashing.paths_to_host_gl).

Both routes, the batched build of small slots
(gl_hashing.batched_slot_layers_gl) and the streaming build of large ones
(models/streaming.py), end in the one tail, _proof_input_gl.

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
from . import hashing as H
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


def _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, build_slots, device, stats):
    """The tail: the dataset tree, sampling, the cells and the paths.
    build_slots() builds every slot's tree and returns the slot roots
    (Digests) and the sampled slot's layer stack; it runs in the slots
    stage, with the dataset tree."""
    with _stage(stats, "slots"):
        roots, stack = build_slots()
        dset_tree = merkle_tree(roots, compress_fn(hash_fun))
        slot_proof = extract_proof(dset_tree, slot_index)
    with _stage(stats, "sample"):
        idxs = GH.sample_indices_gl(hash_fun, entropy, stack[-1], dset.n_samples,
                                    (dset.n_cells - 1).bit_length()).tolist()
    with _stage(stats, "cells"):
        cells = D.load_cells(slot_cfg_from_dataset_cfg(glob, dset, slot_index), np.asarray(idxs))
        cell_data = GH.cell_digests(cells, device)
    with _stage(stats, "paths"):
        merkle_paths = GH.paths_to_host_gl(H.extract_paths_device(
            stack, torch.tensor(idxs, dtype=torch.int64), glob.max_depth))
    if stats is not None:
        stats.samples += len(idxs)
        stats.cell_loads += 1
        stats.cell_bytes += cells.nbytes
    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=roots[slot_index],
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
        stacks = GH.batched_slot_layers_gl(hash_fun, slot_cfgs, device)
        return GH.digests(torch.cat([st[-1] for st in stacks], dim=2)), stacks[slot_index]

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
    """Large-slot path: one streaming chunked build per slot.  Slots other
    than the sampled one keep only their root."""

    def build_slots():
        roots: list[Digest] = []
        stack = None
        for i in range(dset.n_slots):
            cfg = slot_cfg_from_dataset_cfg(glob, dset, i)
            layers = streaming_slot_layers_gl(cfg, hash_fun, chunk_cells, device=device)
            roots.append(GH.digests(layers[-1])[0])
            if i == slot_index:
                stack = layers
        return roots, stack

    return _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, build_slots, device, stats)
