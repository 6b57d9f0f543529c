"""The port's sharded BN254 tree builds (parallel/) on CPU meshes, against
the JAX package's oracle, bit-exact.

Each shard of a mesh of `cpu` entries runs the plain versions, so these
are the sharded code paths of the card at a small size: a 2 x 4 mesh with
an odd slot count (3 slots, one padding slot), both routes (encoded felts,
the JAX package's API, and byte rows), a single slot over a 1 x 8 row,
and single-block slots on 1 and 2 cell shards.
The JAX package's sharded_dataset_build is not called here: it compiles
for over a minute on this CPU (its own tests hold it to the same oracle).
"""

import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.ops import encode as TE
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

BTD = 1  # 16-byte cells, 32-byte blocks
N_SLOTS = 3
CFGS = [SlotConfig(cell_size=16, block_size=32, n_cells=8, n_samples=1,
                   data_src=DataSource("fake", seed=31 + k)) for k in range(N_SLOTS)]
JCFGS = [JS.SlotConfig(cell_size=16, block_size=32, n_cells=8, n_samples=1,
                       data_src=JS.DataSource("fake", seed=31 + k)) for k in range(N_SLOTS)]


def _oracle_layers(cfg: JS.SlotConfig) -> list[list[int]]:
    """The flat cell -> block -> slot layer stack of the oracle's trees."""
    t = JS.calc_slot_tree(cfg)
    btd = cfg.cells_per_block.bit_length() - 1
    low = [[v for m in t.mini_trees for v in m.layers[d]] for d in range(btd)]
    return low + [list(lyr) for lyr in t.big_tree.layers]


def _felts(cfg: SlotConfig) -> torch.Tensor:
    return TE.encode_cells(torch.from_numpy(D.load_slot_cells(cfg)))


@pytest.fixture(scope="module")
def mesh_2x4():
    return P.make_mesh(n_cells_shards=4, n_slot_shards=2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def felts_build(mesh_2x4):
    felts = torch.stack([_felts(CFGS[min(s, N_SLOTS - 1)]) for s in range(4)])
    return P.sharded_dataset_build(felts, mesh_2x4, BTD, n_slots=N_SLOTS)


def _slot_layers(locs, tops, s) -> list[list[int]]:
    return [TL.unpack(P.join(lyr[s])) for lyr in locs] + [TL.unpack(lyr[s]) for lyr in tops]


def test_dataset_build_2x4_matches_oracle(felts_build):
    locs, tops, dlayers = felts_build
    assert len(locs) == 1 and len(tops) == 3  # 2 cells a shard; 4 shards a row
    for s, cfg in enumerate(JCFGS):
        assert len(locs[0][s]) == 4
        assert _slot_layers(locs, tops, s) == _oracle_layers(cfg)
    assert locs[0][3] is None and tops[0][3] is None  # the padding slot is not built
    odset = merkle_tree([JS.calc_slot_tree(c).root for c in JCFGS])
    assert [TL.unpack(lyr) for lyr in dlayers] == odset.layers  # odd width: 3 -> 2 -> 1


def test_byte_row_route_gives_the_felts_routes_layers(mesh_2x4, felts_build):
    locs, tops, dlayers = P.sharded_dataset_build_rows(CFGS, mesh_2x4, BTD)
    f_locs, f_tops, f_dlayers = felts_build
    for s in range(N_SLOTS):
        for d in range(len(locs)):
            assert all(torch.equal(a, b) for a, b in zip(locs[d][s], f_locs[d][s]))
        assert all(torch.equal(a[s], b[s]) for a, b in zip(tops, f_tops))
    assert all(torch.equal(a, b) for a, b in zip(dlayers, f_dlayers))


def test_slot_tree_1x8_matches_oracle():
    mesh = P.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"slots": 1, "cells": 8}
    local, tops = P.sharded_slot_tree_layers(_felts(CFGS[0]), mesh, BTD)
    assert local == [] and len(tops) == 4  # one cell a shard: the frontier is the cell hashes
    assert [TL.unpack(lyr) for lyr in tops] == _oracle_layers(JCFGS[0])


# single-block slots: 16-byte cells, 64-byte blocks, 4 cells a slot
SINGLE = [SlotConfig(cell_size=16, block_size=64, n_cells=4, n_samples=1,
                     data_src=DataSource("fake", seed=21 + k)) for k in range(2)]
JSINGLE = [JS.SlotConfig(cell_size=16, block_size=64, n_cells=4, n_samples=1,
                         data_src=JS.DataSource("fake", seed=21 + k)) for k in range(2)]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_single_block_slots_get_the_oracles_root(n_shards):
    # the oracle's tree over a slot's one block root is a singleton bottom,
    # which gets one bottom-odd compression: the slot root is not the block root
    mesh = P.make_mesh(n_cells_shards=n_shards, devices=["cpu"] * n_shards)
    felts = torch.stack([_felts(c) for c in SINGLE])
    roots = [JS.calc_slot_tree(c).root for c in JSINGLE]
    want_top = [[JS.calc_slot_tree(c).big_tree.layers[0][0], r] for c, r in zip(JSINGLE, roots)]
    for locs, tops, dlayers in (P.sharded_dataset_build(felts, mesh, 2),
                                P.sharded_dataset_build_rows(SINGLE, mesh, 2)):
        for s, cfg in enumerate(JSINGLE):
            assert [TL.unpack(lyr[s])[0] for lyr in tops[-2:]] == want_top[s]
            assert _slot_layers(locs, tops, s) == _oracle_layers(cfg)
        assert [TL.unpack(lyr) for lyr in dlayers] == merkle_tree(roots).layers
    local, tops = P.sharded_slot_tree_layers(felts[0], mesh, 2)
    assert TL.unpack(tops[-1]) == [roots[0]]


def test_mesh_and_build_refuse_bad_shapes(mesh_2x4):
    with pytest.raises(ValueError):
        P.make_mesh(n_cells_shards=4, n_slot_shards=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):  # 3 slots do not split over 2 rows
        P.sharded_dataset_build(torch.zeros((3, 1, 16, 8), dtype=torch.int32), mesh_2x4, BTD)
    with pytest.raises(ValueError):  # 3 shards are not a power of two
        P.sharded_slot_tree_layers(_felts(CFGS[0]), P.make_mesh(3, devices=["cpu"] * 3), BTD)
