"""Goldilocks proof-input generation on the device.

Port of codex_storage_proofs_circuits_tpu/models/gl_proof_input.py, the GL
twin of models/proof_input.py.  Same contract as
oracle.goldilocks_pipeline.generate_proof_input_gl
(gen_input/goldilocks.nim:22-87), with every slot's cell sponges and tree
layers built on the device (models/gl_hashing.py, models/streaming.py).  The
dataset tree over the slot roots, the sampling sponges and the sampled
cells' bytes are small and stay on the host.
"""

from __future__ import annotations

import torch

from ..oracle.dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks import Digest, bytes_to_digests_gl, compress_fn, sample_cell_index_gl
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from ..oracle.merkle import extract_proof, merkle_tree
from ..oracle.slot import load_cell
from . import gl_hashing as GH
from .streaming import DEFAULT_CHUNK_CELLS, streaming_slot_layers_gl


def _proof_input_gl(hash_fun, glob, dset, slot_index, entropy, roots, our_cfg, merkle_paths_of):
    """The shared tail: dataset tree, sampling, cell data, paths."""
    dset_tree = merkle_tree(roots, compress_fn(hash_fun))
    slot_proof = extract_proof(dset_tree, slot_index)
    our_root = roots[slot_index]
    idxs = [
        sample_cell_index_gl(hash_fun, entropy, our_root, dset.n_cells, c)
        for c in range(1, dset.n_samples + 1)
    ]
    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=[bytes_to_digests_gl(load_cell(our_cfg, i)) for i in idxs],
        merkle_paths=merkle_paths_of(idxs),
    )


def generate_proof_input_gl(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
    device="cuda",
) -> ProofInputGL:
    """All slots' trees in one batched device build (every cell of every
    slot is loaded on the host first: for small slots)."""
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

    return _proof_input_gl(hash_fun, glob, dset, slot_index, entropy,
                           [t.root for t in trees], slot_cfgs[slot_index], merkle_paths_of)


def generate_proof_input_gl_streaming(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
    chunk_cells: int = DEFAULT_CHUNK_CELLS,
    device="cuda",
) -> ProofInputGL:
    """Large-slot path: one streaming chunked build per slot and one batched
    gather of the sampled paths on the device.  Slots other than the
    sampled one keep only their root."""
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    roots: list[Digest] = []
    our_layers = None
    for i, cfg in enumerate(slot_cfgs):
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

    return _proof_input_gl(hash_fun, glob, dset, slot_index, entropy,
                           roots, slot_cfgs[slot_index], merkle_paths_of)
