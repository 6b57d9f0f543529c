"""Goldilocks proof-input pipeline: slot trees, dataset tree, sampling,
witness bundling and snarkjs-style JSON export.

Digest-valued twin of the BN254 pipeline (oracle/{slot,sampling}.py),
mirroring reference/nim/proof_input/src/{blocks,gen_input,json}/goldilocks.nim.
Cell data and Merkle nodes are Digests (4 Goldilocks felts); the fake-data
PRNG, per-slot seed derivation and block/slot/dataset shapes are shared with
the BN254 track (they are field-agnostic byte pipelines).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import IO

from .dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from .merkle import MerkleProof, MerkleTree, extract_proof, merkle_tree
from .slot import SlotConfig, SlotTree, load_block, load_cell
from .goldilocks import (
    Digest,
    bytes_to_digests_gl,
    compress_fn,
    digest_bytes,
    sample_cell_index_gl,
)


def block_tree_gl(hash_fun: str, cfg: SlotConfig, block_data: bytes) -> MerkleTree:
    """Mini tree over the digests of the cells in one network block
    (blocks/goldilocks.nim:64-74)."""
    assert len(block_data) == cfg.block_size
    cs = cfg.cell_size
    leaves = [
        digest_bytes(hash_fun, block_data[i * cs : (i + 1) * cs])
        for i in range(cfg.cells_per_block)
    ]
    return merkle_tree(leaves, compress_fn(hash_fun))


def calc_slot_tree_gl(hash_fun: str, cfg: SlotConfig) -> SlotTree:
    """cells -> block mini-trees -> big tree, built once, layers kept
    (gen_input/goldilocks.nim:22-33, minus the per-sample rebuild waste)."""
    comp = compress_fn(hash_fun)
    minis = [
        block_tree_gl(hash_fun, cfg, load_block(cfg, b))
        for b in range(cfg.blocks_per_slot)
    ]
    big = merkle_tree([t.root for t in minis], comp)
    return SlotTree(minis, big)


@dataclass
class ProofInputGL:
    """Digest-valued circuit input bundle (types.nim:48-60 with H=Digest)."""

    entropy: Digest
    data_set_root: Digest
    slot_index: int
    slot_root: Digest
    n_slots_per_dataset: int
    n_cells_per_slot: int
    slot_proof: list[Digest]  # padded to maxLog2NSlots
    cell_data: list[list[Digest]]  # nSamples x digests-per-cell
    merkle_paths: list[list[Digest]]  # nSamples x maxDepth


def _pad_digest_path(path: list, new_len: int) -> list:
    assert len(path) <= new_len
    from .goldilocks import ZERO_DIGEST

    # odd-node siblings come out of the generic tree as the int-0 sentinel
    # (oracle/merkle.py extract_proof); normalize them to the zero digest
    norm = [ZERO_DIGEST if d == 0 else d for d in path]
    return norm + [ZERO_DIGEST] * (new_len - len(norm))


def generate_proof_input_gl(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
) -> ProofInputGL:
    """Full pipeline (gen_input/goldilocks.nim:35-87), slot trees built once."""
    comp = compress_fn(hash_fun)
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    slot_trees = [calc_slot_tree_gl(hash_fun, c) for c in slot_cfgs]
    slot_roots = [t.root for t in slot_trees]

    dset_tree = merkle_tree(slot_roots, comp)
    slot_proof = extract_proof(dset_tree, slot_index)

    our_cfg, our_tree = slot_cfgs[slot_index], slot_trees[slot_index]
    our_root = slot_roots[slot_index]

    idxs = [
        sample_cell_index_gl(hash_fun, entropy, our_root, dset.n_cells, c)
        for c in range(1, dset.n_samples + 1)
    ]

    k = our_cfg.cells_per_block
    cell_data, merkle_paths = [], []
    for idx in idxs:
        block_idx, within = divmod(idx, k)
        bot = extract_proof(our_tree.mini_trees[block_idx], within)
        top = extract_proof(our_tree.big_tree, block_idx)
        path = bot.merkle_path + top.merkle_path
        merkle_paths.append(_pad_digest_path(path, glob.max_depth))
        cell_data.append(bytes_to_digests_gl(load_cell(our_cfg, idx)))

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


def check_proof_input_gl(hash_fun: str, glob: GlobalConfig, pi: ProofInputGL) -> None:
    """Re-derive every circuit-level assertion on a Goldilocks bundle: the
    dataset inclusion, sampled indices, cell digests and two-stage paths."""
    from .merkle import reconstruct_root
    from .goldilocks import digest_felts, digests_to_felts

    comp = compress_fn(hash_fun)
    n_cells = pi.n_cells_per_slot
    log2n = (n_cells - 1).bit_length()
    btd = glob.block_tree_depth

    # singleton-dataset fixup (merkle.circom:53-62): at least one step
    ds_depth = max(1, (pi.n_slots_per_dataset - 1).bit_length())
    ds = MerkleProof(pi.slot_index, pi.slot_root,
                     list(pi.slot_proof[:ds_depth]), pi.n_slots_per_dataset)
    assert reconstruct_root(ds, comp) == pi.data_set_root, "dataset root mismatch"

    for s, (cdata, path) in enumerate(zip(pi.cell_data, pi.merkle_paths)):
        idx = sample_cell_index_gl(hash_fun, pi.entropy, pi.slot_root, n_cells, s + 1)
        leaf = digest_felts(hash_fun, digests_to_felts(cdata))
        bot = MerkleProof(idx & ((1 << btd) - 1), leaf, list(path[:btd]), 1 << btd)
        block_root = reconstruct_root(bot, comp)
        top = MerkleProof(idx >> btd, block_root,
                          list(path[btd:log2n]), n_cells >> btd)
        assert reconstruct_root(top, comp) == pi.slot_root, f"sample {s} mismatch"


# ---------------------------------------------------------------------------
# JSON export: digests as quads of quoted decimal strings
# (json/goldilocks.nim:19-25,70-87, digestToJsonString types/goldilocks.nim:40-46).


def _dj(d: Digest) -> list[str]:
    return [str(v) for v in d]


def proof_input_gl_to_dict(pi: ProofInputGL) -> dict:
    return {
        "dataSetRoot": _dj(pi.data_set_root),
        "entropy": _dj(pi.entropy),
        "nCellsPerSlot": pi.n_cells_per_slot,
        "nSlotsPerDataSet": pi.n_slots_per_dataset,
        "slotIndex": pi.slot_index,
        "slotRoot": _dj(pi.slot_root),
        "slotProof": [_dj(d) for d in pi.slot_proof],
        "cellData": [[_dj(d) for d in cell] for cell in pi.cell_data],
        "merklePaths": [[_dj(d) for d in path] for path in pi.merkle_paths],
    }


def export_proof_input_gl(fname_or_fh: str | IO, pi: ProofInputGL) -> None:
    d = proof_input_gl_to_dict(pi)
    if isinstance(fname_or_fh, str):
        with open(fname_or_fh, "w") as f:
            json.dump(d, f, indent=1)
            f.write("\n")
    else:
        json.dump(d, fname_or_fh, indent=1)
        fname_or_fh.write("\n")
