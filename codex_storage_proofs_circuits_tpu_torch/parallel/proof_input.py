"""Mesh-sharded end-to-end proof-input generation, both fields.

Port of codex_storage_proofs_circuits_tpu/parallel/proof_input.py.  After
the sharded dataset build (byte-row route, parallel/tree.py and
parallel/gl_tree.py):

  * sampling runs on the device from the slot root that lives there, with
    the single-device proof inputs' samplers: models/hashing.sample_indices
    for BN254 (two K1 permutations for every counter) and
    models/gl_hashing.sample_indices_gl for Goldilocks (one K6 sponge);
  * the Merkle paths gather from the sharded layers: at each depth the
    shard that owns a sampled index's sibling answers for it, and only the
    nSamples x maxDepth nodes come back (across processes by one
    all_reduce, each node non-zero in one process only), converted as the
    single-device paths are (hashing.paths_to_host,
    gl_hashing.paths_to_host_gl);
  * the sampled cells are reread on the host in one models/data.load_cells
    call, as the single-device paths do (gathering them from felts would
    need the whole slot's felts), and Goldilocks encodes them with
    gl_hashing.cell_digests.

The result equals the oracle's ProofInput / ProofInputGL exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import data as D
from ..models import gl_hashing as GH
from ..models import hashing as H
from ..ops import limbs as L
from ..oracle.dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks import Digest
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from ..oracle.merkle import MerkleTree, extract_proof
from ..oracle.sampling import ProofInput
from ..oracle.slot import cell_data_to_field_elements
from .distributed import sum_over_processes
from .gl_tree import sharded_gl_dataset_build_rows
from .mesh import Mesh, cells_axis, slots_axis
from .tree import sharded_dataset_build_rows

NL = L.NL


def _sample_and_gather(mesh: Mesh, slot: int, locs, tops, sample, node: tuple[int, ...],
                       n_samples: int, max_depth: int):
    """(indices, slot root (node + (1,)), paths (max_depth, *node, S)) of
    one slot, on the host, in every process.  The processes of the slot's
    row sample from its root; each shard answers the siblings in its own
    segment, the row's first shard those of the top layers."""
    g = slot // (len(tops[-1]) // mesh.shape[slots_axis])  # tops[d]: one entry a padded slot
    n_cs = mesh.shape[cells_axis]
    n_local = len(locs)
    n_tree = n_local + len(tops) - 1
    idx = torch.zeros(n_samples, dtype=torch.int64)
    root = torch.zeros(node + (1,), dtype=torch.int32)
    paths = torch.zeros((max_depth,) + node + (n_samples,), dtype=torch.int32)
    if mesh.local_row(g):
        dev = mesh.row_device(g)
        idx_dev = sample(tops[-1][slot])
        idx_host = idx_dev.tolist()
        for d in range(min(n_tree, max_depth)):
            sib = [(i >> d) ^ 1 for i in idx_host]
            if d < n_local:
                span = n_local - d  # log2 of a shard's width at depth d
                for c in range(n_cs):
                    ks = [k for k, j in enumerate(sib) if j >> span == c]
                    if ks and mesh.is_local(g, c):
                        layer = locs[d][slot][c]
                        at = torch.tensor([sib[k] & ((1 << span) - 1) for k in ks],
                                          device=layer.device)
                        paths[d][..., ks] = layer.index_select(-1, at).cpu()
            elif mesh.row_leader(g):
                at = torch.tensor(sib, device=dev)
                paths[d] = tops[d - n_local][slot].index_select(-1, at).cpu()
        if mesh.row_leader(g):
            idx = idx_dev.cpu()
            root = tops[-1][slot].cpu()
    if mesh.multiprocess:
        flat = sum_over_processes(torch.cat([idx, root.flatten().long(), paths.flatten().long()]))
        idx = flat[:n_samples]
        root = flat[n_samples : n_samples + root.numel()].int().reshape(root.shape)
        paths = flat[n_samples + root.numel():].int().reshape(paths.shape)
    return idx.tolist(), root, paths


def _check_multi_block(glob: GlobalConfig, dset: DataSetConfig) -> None:
    if dset.n_cells <= glob.cells_per_block:
        raise ValueError("the sharded builds need a multi-block slot (the flat layer stack"
                         " has no single-block root)")


def sharded_proof_input(glob: GlobalConfig, dset: DataSetConfig, slot_index: int,
                        entropy: int, mesh: Mesh) -> ProofInput:
    """The BN254 proof input with every compute stage on the mesh.  Same
    contract as oracle.sampling.generate_proof_input
    (gen_input/bn254.nim:35-74), slots sharded on the "slots" axis and
    cells on "cells"."""
    _check_multi_block(glob, dset)
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    locs, tops, dlayers = sharded_dataset_build_rows(cfgs, mesh, glob.block_tree_depth)
    dset_tree = MerkleTree([L.unpack(lyr) for lyr in dlayers])
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    log2n = (dset.n_cells - 1).bit_length()
    idxs, root, paths = _sample_and_gather(
        mesh, slot_index, locs, tops,
        lambda r: H.sample_indices(entropy, r, dset.n_samples, log2n),
        (NL,), dset.n_samples, glob.max_depth)
    cells = D.load_cells(cfgs[slot_index], np.asarray(idxs))
    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=L.unpack(root)[0],
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=[cell_data_to_field_elements(c.tobytes()) for c in cells],
        merkle_paths=H.paths_to_host(paths),
    )


def sharded_gl_proof_input(hash_fun: str, glob: GlobalConfig, dset: DataSetConfig,
                           slot_index: int, entropy: Digest, mesh: Mesh) -> ProofInputGL:
    """The Goldilocks proof input with every compute stage on the mesh
    (gen_input/goldilocks.nim:22-87 contract)."""
    _check_multi_block(glob, dset)
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    locs, tops, dlayers = sharded_gl_dataset_build_rows(cfgs, mesh, hash_fun,
                                                        glob.block_tree_depth)
    dset_tree = MerkleTree([GH.digests(lyr) for lyr in dlayers])
    slot_proof = extract_proof(dset_tree, slot_index)

    log2n = (dset.n_cells - 1).bit_length()
    idxs, root, paths = _sample_and_gather(
        mesh, slot_index, locs, tops,
        lambda r: GH.sample_indices_gl(hash_fun, entropy, r, dset.n_samples, log2n),
        (GH.FELTS_PER_DIGEST, GH.NL), dset.n_samples, glob.max_depth)
    cells = D.load_cells(cfgs[slot_index], np.asarray(idxs))
    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=GH.digests(root)[0],
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=GH.cell_digests(cells, dlayers[0].device),  # this process's device
        merkle_paths=GH.paths_to_host_gl(paths),
    )
