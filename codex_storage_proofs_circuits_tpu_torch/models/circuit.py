"""Witness / constraint evaluation for the SampleAndProve statement.

Port of codex_storage_proofs_circuits_tpu/models/circuit.py.  Evaluates the
reference circuit's semantics (circuit/codex/sample_cells.circom:58-148,
single_cell.circom:30-73, merkle.circom:44-114) against a ProofInput, that
is every `===` assertion the Groth16 circuit would enforce:

  1. dataset-level inclusion: the slot root reconstructs the dataset root
     along slotProof under the variable-depth masked path
     (sample_cells.circom:95-109);
  2. per sample: the cell index is the low log2(nCells) bits of
     H(entropy|slotRoot|counter) (CalculateCellIndexBits,
     sample_cells.circom:23-48);
  3. per sample: the cell data hashes (rate-2 sponge over exactly
     nFieldElemsPerCell felts) and re-walks the two-stage merged path,
     depth-b block tree then variable-depth slot tree, to the slot root
     (single_cell.circom:41-71).

Two implementations with identical verdicts: a scalar host checker over the
port's oracle (check_circuit_semantics) and a batched device evaluator
(verify_proof_input_device) that runs the index sponges and the cell
sponges as one batch each (kernel K2's limb-plane entry on the card) and
walks every sample's Merkle path as one batched permutation a depth
(kernel K1).
"""

from __future__ import annotations

import torch

from ..fields.bn254 import P
from ..oracle.dataset import DataSetConfig, GlobalConfig
from ..oracle.merkle import MerkleProof, reconstruct_root
from ..oracle.poseidon2 import sponge2
from ..oracle.sampling import ProofInput
from ..oracle.slot import hash_cell_felts
from ..ops import limbs as L
from ..ops import poseidon2_plain as P2
from . import hashing as H

NL = L.NL


class CircuitCheckError(AssertionError):
    """A `===` assertion of the circuit semantics failed."""


def _ceiling_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 0 else -1


def check_circuit_semantics(
    glob: GlobalConfig, dset: DataSetConfig, pi: ProofInput
) -> None:
    """Scalar host evaluation of every circuit assertion; raises on failure."""
    n_cells = pi.n_cells_per_slot
    n_slots = pi.n_slots_per_dataset
    log2_n_cells = _ceiling_log2(n_cells)
    if 1 << log2_n_cells != n_cells:
        raise CircuitCheckError("nCells must be a power of two")
    btd = glob.block_tree_depth
    nfe = glob.n_field_elems_per_cell

    if len(pi.slot_proof) != glob.max_log2_n_slots:
        raise CircuitCheckError("slotProof not padded to maxLog2NSlots")

    # (1) dataset-level inclusion (sample_cells.circom:95-109)
    # singleton-dataset fixup: the circuit forces one bottom-odd step even
    # when ceilingLog2(nSlots) == 0 (merkle.circom:53-62 maskBitsCorrected)
    ds_depth = max(1, _ceiling_log2(n_slots))
    ds_proof = MerkleProof(
        pi.slot_index, pi.slot_root, list(pi.slot_proof[:ds_depth]), n_slots
    )
    if reconstruct_root(ds_proof) != pi.data_set_root:
        raise CircuitCheckError("recRoot === dataSetRoot failed")

    for k, (cdata, path) in enumerate(zip(pi.cell_data, pi.merkle_paths)):
        counter = k + 1  # counter = cnt + 1 (sample_cells.circom:138)
        if len(cdata) != nfe:
            raise CircuitCheckError(f"sample {k}: cellData length != {nfe}")
        if len(path) != glob.max_depth:
            raise CircuitCheckError(f"sample {k}: path not padded to maxDepth")
        if any(not (0 <= v < P) for v in cdata):
            raise CircuitCheckError(f"sample {k}: cellData felt out of range")

        # (2) sampled index (CalculateCellIndexBits)
        idx = sponge2([pi.entropy, pi.slot_root, counter]) & (n_cells - 1)

        # (3) two-stage path walk (ProveSingleCell)
        cell_hash = hash_cell_felts(cdata)
        bot = MerkleProof(idx & ((1 << btd) - 1), cell_hash, list(path[:btd]), 1 << btd)
        block_root = reconstruct_root(bot)
        top = MerkleProof(
            idx >> btd, block_root, list(path[btd:log2_n_cells]), n_cells >> btd
        )
        if reconstruct_root(top) != pi.slot_root:
            raise CircuitCheckError(f"sample {k}: recRoot === slotRoot failed")


# ---------------------------------------------------------------------------
# Batched device evaluation.


def _masked_path_walk(
    leaves_mont: torch.Tensor,  # (NL, B) Montgomery leaf values
    paths_mont: torch.Tensor,  # (D, NL, B) Montgomery siblings
    index_bits: torch.Tensor,  # (D, B) 0/1, little-endian bit per depth
    depth_mask: torch.Tensor,  # (D, B) 0/1: 1 while depth < the real depth
    keys: list[int],  # Merkle key (0..3) of each depth
) -> torch.Tensor:
    """Variable-depth keyed Merkle walk, the twin of RootFromMerklePath's
    maskBits layer-select (merkle.circom:106-113): at each depth the state
    [x, y, key] with (x, y) ordered by the index bit goes through one
    batched permutation (K1 on the card), and the result is kept where the
    depth is below the real depth."""
    h = leaves_mont
    for sib, bit, mask, key in zip(paths_mont, index_bits.bool(), depth_mask.bool(), keys):
        x = torch.where(bit, sib, h)
        y = torch.where(bit, h, sib)
        k = P2.KEY_MONT[key].to(h.device, h.dtype).expand_as(h)
        out = H.permute(torch.stack([x, y, k]))[0]
        h = torch.where(mask, out, h)
    return h


def _sponge2_batch(felts: torch.Tensor) -> torch.Tensor:
    """(nfelts, NL, B) canonical felts -> (NL, B) Montgomery rate-2 sponge
    outputs, one launch of K2's limb-plane entry on the card."""
    return H.sponge2_scan(P2.pad_felts_rate2(P2.to_mont_stack(felts)))


def verify_proof_input_device(glob: GlobalConfig, pi: ProofInput, device="cuda") -> bool:
    """Full device re-derivation of the circuit assertions.

    Everything per sample is batched device work: the nSamples index
    sponges (H(entropy|slotRoot|counter), low bits of the canonical output),
    the nSamples cell hashes as one sponge batch, the nSamples two-stage path
    walks as one batched permutation a depth, and the dataset-level
    inclusion walk (odd-node key schedule).  The host only packs inputs and
    reads back one boolean.
    """
    n_cells = pi.n_cells_per_slot
    log2_n_cells = _ceiling_log2(n_cells)
    if not 0 <= log2_n_cells <= 32:
        raise ValueError(f"nCells {n_cells} out of range")
    btd = glob.block_tree_depth
    n = len(pi.cell_data)
    max_depth = glob.max_depth

    # (1) sampled indices: one batched sponge over (entropy, slotRoot, k+1)
    triples = torch.stack([
        L.pack([pi.entropy] * n, device),
        L.pack([pi.slot_root] * n, device),
        L.pack(range(1, n + 1), device),
    ])  # (3, NL, n)
    hash_can = L.from_mont(_sponge2_batch(triples)).to(torch.int64)  # (NL, n)
    idx = (hash_can[0] | (hash_can[1] << 16)) & (n_cells - 1)  # low 32 bits
    d_iota = torch.arange(max_depth, device=idx.device)[:, None]
    bits = (idx[None, :] >> d_iota) & 1  # (max_depth, n)
    mask = (d_iota < log2_n_cells).expand(max_depth, n)

    # (2) batched cell hashes
    cells = torch.stack([
        L.pack([pi.cell_data[k][f] for k in range(n)], device)
        for f in range(len(pi.cell_data[0]))
    ])  # (nfe, NL, n)
    leaf_mont = _sponge2_batch(cells)

    # (3) batched masked two-stage path walk: key 1 at depth 0 and at the
    # block-tree depth, where the block roots become the bottom layer
    paths = torch.stack([
        L.pack([pi.merkle_paths[k][d] for k in range(n)], device) for d in range(max_depth)
    ])  # (max_depth, NL, n)
    keys = [1 if d in (0, btd) else 0 for d in range(max_depth)]
    roots_mont = _masked_path_walk(leaf_mont, P2.to_mont_stack(paths), bits, mask, keys)
    want_root = L.to_mont(L.pack([pi.slot_root] * n, device))
    samples_ok = torch.all(roots_mont == want_root)

    # (4) dataset-level inclusion (sample_cells.circom:95-109): one walk with
    # the odd-capable key schedule of the keyed convention (merkle.circom
    # key = bottom + 2*odd; odd iff the node is last in its row with no
    # right sibling, merkle.nim:51-74).  A singleton dataset tree still
    # walks one bottom-odd compression (maskBitsCorrected[0] = 1,
    # merkle.circom:53-62).
    n_slots = pi.n_slots_per_dataset
    ds_depth = max(1, _ceiling_log2(n_slots))
    si = pi.slot_index
    ds_keys = []
    j, last = si, n_slots - 1
    for d in range(ds_depth):
        odd = 1 if (j == (last >> d) and (j & 1) == 0) else 0
        ds_keys.append((1 if d == 0 else 0) + 2 * odd)
        j >>= 1
    ds_bits = torch.tensor([[(si >> d) & 1] for d in range(ds_depth)], device=idx.device)
    ds_mask = torch.ones((ds_depth, 1), dtype=torch.int64, device=idx.device)
    ds_path = torch.stack([L.pack([pi.slot_proof[d]], device) for d in range(ds_depth)])
    ds_root_mont = _masked_path_walk(
        L.to_mont(L.pack([pi.slot_root], device)), P2.to_mont_stack(ds_path),
        ds_bits, ds_mask, ds_keys,
    )
    ds_ok = torch.all(ds_root_mont == L.to_mont(L.pack([pi.data_set_root], device)))
    return bool(torch.logical_and(samples_ok, ds_ok).item())
