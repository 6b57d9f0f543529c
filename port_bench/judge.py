"""The comparison that decides `correct`, on the plain reference alone.

This module imports nothing of the program: it reads the program's outputs
(slot roots, digest layers as canonical int32 limb planes, the exported
proof-input JSON) only to judge them, and works everything out again with
`port_bench/reference/`.

A slot commit is judged by its root.  A plain rebuild of a whole 1 GiB slot
costs more than a run (the plain cell hash takes about 35 s per 2^18 cells
on an H100), so the judge follows the program's own digest layers: it
hashes a sample of cells, drawn from the seed, from the bytes the benchmark
made (start), and recomputes every node of every layer above from the
layers' children (stage); the root it computes at the top must equal the
root the timed call returned.  Every number it reports is a count of
disagreements, with the limit 0.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .reference import gl_plain as GP
from .reference.fake_data import gen_fake_cells
from .reference import limbs as L
from .reference import merkle as RM
from .reference import p2_plain as P2
from .reference import sampling as RS
from .reference import slot as RSL

# Columns a plain call takes at once: the plain permutations hold int64
# temporaries of a few hundred bytes a column.
BLOCK = 1 << 17


class Bn254:
    """Poseidon2 over BN254: (16, w) canonical limb planes, a root is an int."""

    def leaves(self, rows: torch.Tensor) -> torch.Tensor:
        return L.from_mont(P2.sponge2_rows(rows))

    def nodes(self, key: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return L.from_mont(P2.compress(L.to_mont(x), L.to_mont(y), P2.KEY_MONT[key]))

    def value(self, col: torch.Tensor):
        return L.unpack(col)[0]


class Goldilocks:
    """Goldilocks with one hash: (4, 4, w) canonical digests, a root is a
    tuple of 4 ints."""

    def __init__(self, hash_fun: str):
        self.hash_fun = hash_fun

    def leaves(self, rows: torch.Tensor) -> torch.Tensor:
        return GP.sponge_digest_rows(self.hash_fun, rows)

    def nodes(self, key: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return GP.compress_batch(self.hash_fun, key, x, y)

    def value(self, col: torch.Tensor):
        return tuple(GP.unpack(col[j])[0] for j in range(col.shape[0]))


def field_of(cfg: dict):
    if cfg["field"] == "bn254":
        return Bn254()
    return Goldilocks(cfg["hash"])


def _blocks(fn, *xs: torch.Tensor) -> torch.Tensor:
    w = xs[0].shape[-1]
    return torch.cat([fn(*(x[..., a:a + BLOCK] for x in xs)) for a in range(0, w, BLOCK)], -1)


def _bad_columns(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).reshape(-1, a.shape[-1]).any(0).sum())


@dataclass
class SlotCase:
    """One slot to judge: the program's digest layers (bottom first), a
    reader of its cells' bytes, and leaves that must be among those hashed."""

    layers: list[torch.Tensor]
    n_cells: int
    cells: Callable[[np.ndarray], np.ndarray]  # (B,) indices -> (B, cell_size) uint8
    forced: list[int] = field(default_factory=list)


def key_of(depth: int, btd: int) -> int:
    """The Merkle key of the compressions above layer `depth` of a slot tree
    of whole blocks: the bottom key at the cells and at the block roots."""
    return RM.KEY_BOTTOM_LAYER if depth in (0, btd) else RM.KEY_NONE


def verify_slots(fld, cases: list[SlotCase], btd: int, n_leaf: int, rng: random.Random,
                 device) -> tuple[dict, list]:
    """Judge slot trees of equal size.  Returns the counts
    {leaf_mismatches, node_mismatches} and, for each slot, the root the
    reference computes from the layers' top pair (None where the layers
    have the wrong shape)."""
    counts = {"leaf_mismatches": 0, "node_mismatches": 0}
    n = cases[0].n_cells
    depth = n.bit_length() - 1
    shaped = []
    for c in cases:
        ok = len(c.layers) == depth + 1 and all(
            lyr.shape[-1] == n >> d for d, lyr in enumerate(c.layers))
        if not ok:
            counts["node_mismatches"] += 2 * n - 1
        shaped.append(ok)
    live = [c for c, ok in zip(cases, shaped) if ok]
    if live:
        # start: a sample of cells from the bytes, hashed in one plain call
        picks = [sorted(set(rng.sample(range(n), min(n_leaf, n))) | set(c.forced)) for c in live]
        rows = torch.from_numpy(np.concatenate(
            [c.cells(np.asarray(p, dtype=np.int64)) for c, p in zip(live, picks)]).T.copy())
        got = _blocks(fld.leaves, rows.to(device))
        at = 0
        for c, p in zip(live, picks):
            idx = torch.tensor(p, dtype=torch.int64, device=device)
            mine = c.layers[0].to(device).index_select(-1, idx)
            counts["leaf_mismatches"] += _bad_columns(got[..., at:at + len(p)], mine)
            at += len(p)
        # stage: every node from its two children, layer by layer
        for d in range(depth):
            lower = torch.cat([c.layers[d].to(device) for c in live], -1)
            upper = torch.cat([c.layers[d + 1].to(device) for c in live], -1)
            want = _blocks(lambda x, y: fld.nodes(key_of(d, btd), x, y),
                           lower[..., 0::2], lower[..., 1::2])
            counts["node_mismatches"] += _bad_columns(want, upper)
            if d == depth - 1:
                tops = [fld.value(want[..., k:k + 1]) for k in range(len(live))]
            del lower, upper, want
    roots, k = [], 0
    for ok in shaped:
        roots.append(tops[k] if ok else None)
        k += ok
    return counts, roots


def plain_layers(fld, cells: Callable[[np.ndarray], np.ndarray], n: int, btd: int, device,
                 keyed: bool = True) -> list[torch.Tensor]:
    """The whole slot tree by the reference (the control puts it in the
    program's place): every cell hash, then every layer.  keyed=False drops
    the Merkle keys (key 0 everywhere), the guarantee the control breaks."""
    hashes = []
    for a in range(0, n, BLOCK):
        idx = np.arange(a, min(n, a + BLOCK), dtype=np.int64)
        hashes.append(fld.leaves(torch.from_numpy(cells(idx).T.copy()).to(device)))
    layers = [torch.cat(hashes, -1)]
    for d in range(n.bit_length() - 1):
        cur = layers[-1]
        key = key_of(d, btd) if keyed else RM.KEY_NONE
        layers.append(_blocks(lambda x, y: fld.nodes(key, x, y), cur[..., 0::2], cur[..., 1::2]))
    return layers


# ---------------------------------------------------------------------------
# Data readers, the benchmark's own: fake cells from the reference's
# generator, file cells from the raw file both sides read.


def fake_cells(cell_size: int, seed: int):
    return lambda idx: gen_fake_cells(cell_size, seed, idx)


def file_cells(cell_size: int, path: str):
    def read(idx: np.ndarray) -> np.ndarray:
        data = np.memmap(path, dtype=np.uint8, mode="r").reshape(-1, cell_size)
        return np.array(data[idx])

    return read


# ---------------------------------------------------------------------------
# The proof input (BN254): the exported JSON against the reference.


def _ints(xs) -> list[int]:
    return [int(v) for v in xs]


def _row_mismatches(got: list, want: list) -> int:
    """Rows that differ, and rows missing or extra on either side."""
    return sum(1 for a, b in zip(got, want) if a != b) + abs(len(got) - len(want))


def check_proof_json(doc: dict, *, entropy: int, n_cells: int, n_slots: int, slot_index: int,
                     n_samples: int, max_depth: int, max_log2_slots: int, cell_size: int,
                     slot_seed: int, roots: list, layers: list[torch.Tensor]) -> dict:
    """Compare one exported proof input with the reference.  roots: the
    reference's roots of every slot (None where it could not compute one);
    layers: the proven slot's digest layers, already judged by verify_slots
    with the sampled cells and their siblings among its leaves."""
    counts = {"field_mismatches": 0, "cell_mismatches": 0, "path_mismatches": 0}
    if any(r is None for r in roots):
        counts["field_mismatches"] += 1 + max_log2_slots
        return counts
    tree = RM.merkle_tree(roots)
    proof = RM.extract_proof(tree, slot_index).padded(max_log2_slots).merkle_path
    root = roots[slot_index]
    want = {"dataSetRoot": tree.root, "entropy": entropy, "nCellsPerSlot": n_cells,
            "nSlotsPerDataSet": n_slots, "slotIndex": slot_index, "slotRoot": root}
    for k, v in want.items():
        try:
            ok = int(doc[k]) == v
        except (KeyError, TypeError, ValueError):
            ok = False
        counts["field_mismatches"] += not ok
    counts["field_mismatches"] += _row_mismatches(_ints(doc.get("slotProof", [])), proof)

    idxs = RS.sample_cell_indices(entropy, root, n_cells, n_samples)
    cells = fake_cells(cell_size, slot_seed)(np.asarray(idxs, dtype=np.int64))
    want_cells = [RSL.cell_data_to_field_elements(c.tobytes()) for c in cells]
    counts["cell_mismatches"] = _row_mismatches(
        [_ints(r) for r in doc.get("cellData", [])], want_cells)

    depth = len(layers) - 1
    sib = torch.tensor([[(i >> d) ^ 1 for d in range(depth)] for i in idxs], dtype=torch.int64)
    vals = [[None] * depth for _ in idxs]
    for d in range(depth):
        col = layers[d].index_select(-1, sib[:, d].to(layers[d].device)).cpu()
        for s in range(len(idxs)):
            vals[s][d] = L.unpack(col[..., s:s + 1])[0]
    want_paths = [v + [0] * (max_depth - depth) for v in vals]
    counts["path_mismatches"] = _row_mismatches(
        [_ints(r) for r in doc.get("merklePaths", [])], want_paths)
    return counts


def proof_leaves(entropy: int, root: int, n_cells: int, n_samples: int) -> list[int]:
    """The leaves a proof input's paths start from, and their siblings."""
    idxs = RS.sample_cell_indices(entropy, root, n_cells, n_samples)
    return sorted(set(idxs) | {i ^ 1 for i in idxs})
