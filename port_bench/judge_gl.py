"""The Goldilocks proof input's exported JSON against the reference.

The GL twin of judge.check_proof_json, on the plain reference alone: it
imports nothing of the program.  A digest is 4 felts, written as 4 quoted
decimals (json/goldilocks.nim:70-87).  The slot trees are judged first by
judge.verify_slots, with the sampled cells and their siblings among the
leaves it hashes (proof_leaves_gl); the paths are then read from the
proven slot's judged layers.  Every number is a count of disagreements,
with the limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .judge import _row_mismatches, fake_cells
from .reference import gl_oracle as RG
from .reference import merkle as RM


def sample_indices_gl(hash_fun: str, entropy, root, n_cells: int, n_samples: int) -> list[int]:
    """The cells a challenge samples (sample/goldilocks.nim:18-38)."""
    return [RG.sample_cell_index_gl(hash_fun, entropy, root, n_cells, c)
            for c in range(1, n_samples + 1)]


def proof_leaves_gl(idxs: list[int]) -> list[int]:
    """The leaves a proof input's paths start from, and their siblings."""
    return sorted(set(idxs) | {i ^ 1 for i in idxs})


def _digest(x):
    """A JSON digest (4 decimal strings) -> a tuple of 4 ints, or None."""
    try:
        d = tuple(int(v) for v in x)
    except (TypeError, ValueError):
        return None
    return d if len(d) == 4 else None


def _digest_rows(rows) -> list:
    return [[_digest(d) for d in row] for row in rows]


def _column_digests(planes: torch.Tensor) -> list[tuple[int, ...]]:
    """(4, 4, S) canonical limb planes -> S digests."""
    arr = planes.cpu().numpy().astype(np.uint64)
    vals = arr[:, 0] | (arr[:, 1] << np.uint64(16)) | (arr[:, 2] << np.uint64(32)) | (
        arr[:, 3] << np.uint64(48))
    return [tuple(int(v) for v in col) for col in vals.T]


def _pad(path: list, n: int) -> list:
    """A path with the oracle's int 0 for a missing sibling, as zero
    digests, padded with zero digests to n."""
    return [RG.ZERO_DIGEST if d == 0 else d for d in path] + [RG.ZERO_DIGEST] * (n - len(path))


def check_proof_json_gl(doc: dict, *, hash_fun: str, entropy, n_cells: int, n_slots: int,
                        slot_index: int, n_samples: int, max_depth: int, max_log2_slots: int,
                        cell_size: int, slot_seed: int, roots: list,
                        layers: list[torch.Tensor]) -> dict:
    """Compare one exported GL proof input with the reference.  entropy: the
    challenge's digest; roots: the reference's roots of every slot (None
    where it could not compute one); layers: the proven slot's digest
    layers, already judged by verify_slots."""
    counts = {"field_mismatches": 0, "cell_mismatches": 0, "path_mismatches": 0}
    if any(r is None for r in roots):
        counts["field_mismatches"] += 1 + max_log2_slots
        return counts
    tree = RM.merkle_tree(roots, RG.compress_fn(hash_fun))
    proof = _pad(RM.extract_proof(tree, slot_index).merkle_path, max_log2_slots)
    root = roots[slot_index]
    for k, v in {"dataSetRoot": tree.root, "entropy": entropy, "slotRoot": root}.items():
        counts["field_mismatches"] += _digest(doc.get(k)) != v
    for k, v in {"nCellsPerSlot": n_cells, "nSlotsPerDataSet": n_slots,
                 "slotIndex": slot_index}.items():
        try:
            ok = int(doc[k]) == v
        except (KeyError, TypeError, ValueError):
            ok = False
        counts["field_mismatches"] += not ok
    counts["field_mismatches"] += _row_mismatches(
        [_digest(d) for d in doc.get("slotProof", [])], proof)

    idxs = sample_indices_gl(hash_fun, entropy, root, n_cells, n_samples)
    cells = fake_cells(cell_size, slot_seed)(np.asarray(idxs, dtype=np.int64))
    want_cells = [RG.bytes_to_digests_gl(c.tobytes()) for c in cells]
    counts["cell_mismatches"] = _row_mismatches(_digest_rows(doc.get("cellData", [])), want_cells)

    depth = len(layers) - 1
    at = torch.tensor(idxs, dtype=torch.int64, device=layers[0].device)
    per_depth = [_column_digests(layers[d].index_select(-1, (at >> d) ^ 1)) for d in range(depth)]
    want_paths = [_pad([per_depth[d][s] for d in range(depth)], max_depth)
                  for s in range(len(idxs))]
    counts["path_mismatches"] = _row_mismatches(
        _digest_rows(doc.get("merklePaths", [])), want_paths)
    return counts
