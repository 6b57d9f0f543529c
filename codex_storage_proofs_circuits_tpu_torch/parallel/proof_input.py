"""Mesh-sharded end-to-end proof-input generation, both fields.

Port of codex_storage_proofs_circuits_tpu/parallel/proof_input.py.  After
the sharded dataset build (byte-row route, parallel/tree.py and
parallel/gl_tree.py):

  * sampling runs on the device from the slot root that lives there:
    BN254's sponge2([entropy, slotRoot, counter]) is two permutations, the
    first independent of the counter, so it runs once and one batched
    permutation spans the counters (K1); Goldilocks digests
    [entropy | root | intToDigest(counter)] in one batched sponge (K6's
    felts entry);
  * the Merkle paths gather from the sharded layers: at each depth the
    shard that owns a sampled index's sibling answers for it, and only the
    nSamples x maxDepth nodes come back (across processes by one
    all_reduce, each node non-zero in one process only);
  * the sampled cells are reread on the host (models/data.load_cells), as
    the single-device paths do: gathering them from felts would need the
    whole slot's felts.

The result equals the oracle's ProofInput / ProofInputGL exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bn254
from ..models import data as D
from ..models import gl_hashing as GH
from ..models import hashing as H
from ..ops import goldilocks_cuda as GC
from ..ops import goldilocks_plain as GP
from ..ops import limbs as L
from ..ops import poseidon2_plain as P2
from ..oracle.dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks import Digest, bytes_to_digests_gl
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from ..oracle.merkle import MerkleTree, extract_proof
from ..oracle.sampling import ProofInput
from ..oracle.slot import cell_data_to_field_elements, load_cell
from .distributed import sum_over_processes
from .gl_tree import sharded_gl_dataset_build_rows
from .mesh import Mesh, cells_axis, slots_axis
from .tree import sharded_dataset_build_rows

NL = L.NL


def sample_indices(entropy: int, root: torch.Tensor, n_samples: int, log2n: int) -> torch.Tensor:
    """BN254 cell indices of counters 1..n_samples, on the root's device.

    root: (NL, 1) canonical slot root.  Index = low log2n bits of the
    canonical sponge2([entropy, root, counter]) (extractLowBits,
    types/bn254.nim:47-59)."""
    if log2n > 32:
        raise ValueError(f"log2 nCells {log2n} > 32")
    dev = root.device
    ent = L.pack([bn254.to_mont(entropy)], dev)
    counters = L.pack([bn254.to_mont(c) for c in range(1, n_samples + 1)], dev)
    iv = P2.SPONGE2_IV_MONT.to(dev, torch.int32)
    st1 = H.permute(torch.stack([ent, L.to_mont(root), iv]))  # (3, NL, 1)
    one = P2.ONE_MONT.to(dev, torch.int32)  # the `10*` padding felt
    s = n_samples
    x = L.add_mod(st1[0].expand(NL, s), counters)
    y = L.add_mod(st1[1], one).expand(NL, s)
    h = L.from_mont(H.permute(torch.stack([x, y, st1[2].expand(NL, s)]))[0]).to(torch.int64)
    return (h[0] | (h[1] << 16)) & ((1 << log2n) - 1)


def _digest_planes(d: Digest, device) -> torch.Tensor:
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
        _digest_planes(entropy, dev).expand(4, GP.NL, s),
        root.expand(4, GP.NL, s),
        GP.pack(range(1, s + 1), dev).unsqueeze(0),
        torch.zeros((3, GP.NL, s), dtype=torch.int32, device=dev),
    ])  # (12, 4, S)
    h = GC.sponge_digest_felts(felts, hash_fun).to(torch.int64)
    return (h[0, 0] | (h[0, 1] << 16)) & ((1 << log2n) - 1)


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
        lambda r: sample_indices(entropy, r, dset.n_samples, log2n),
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
        merkle_paths=[L.unpack(paths[:, :, k].T) for k in range(dset.n_samples)],
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
        lambda r: sample_indices_gl(hash_fun, entropy, r, dset.n_samples, log2n),
        (GH.FELTS_PER_DIGEST, GH.NL), dset.n_samples, glob.max_depth)
    per_depth = [GH.digests(paths[d]) for d in range(glob.max_depth)]
    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=GH.digests(root)[0],
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=[bytes_to_digests_gl(load_cell(cfgs[slot_index], i)) for i in idxs],
        merkle_paths=[[per_depth[d][k] for d in range(glob.max_depth)]
                      for k in range(dset.n_samples)],
    )
