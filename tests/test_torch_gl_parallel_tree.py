"""The port's sharded Goldilocks tree builds (parallel/gl_tree.py) on CPU
meshes, both hashes, against the JAX package's GL oracle,
bit-exact: a 2 x 4 mesh with
an odd slot count over both routes (encoded felts and byte rows), a
1 x 8 row, and single-block slots (Monolith) on 1 and 2 cell shards."""

import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import compress_fn
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

BTD = 1  # 16-byte cells, 32-byte blocks
N_SLOTS = 3
CFGS = [SlotConfig(cell_size=16, block_size=32, n_cells=8, n_samples=1,
                   data_src=DataSource("fake", seed=41 + k)) for k in range(N_SLOTS)]
JCFGS = [JS.SlotConfig(cell_size=16, block_size=32, n_cells=8, n_samples=1,
                       data_src=JS.DataSource("fake", seed=41 + k)) for k in range(N_SLOTS)]
HASHES = ["poseidon2", "monolith"]


def _oracle_layers(hash_fun: str, cfg: JS.SlotConfig) -> list[list]:
    t = calc_slot_tree_gl(hash_fun, cfg)
    low = [[v for m in t.mini_trees for v in m.layers[d]] for d in range(BTD)]
    return low + [list(lyr) for lyr in t.big_tree.layers]


def _felts(cfg: SlotConfig) -> torch.Tensor:
    return GH.encode_cells_gl(D.load_slot_cells(cfg))


def _slot_layers(locs, tops, s) -> list[list]:
    return [GH.digests(P.join(lyr[s])) for lyr in locs] + [GH.digests(lyr[s]) for lyr in tops]


@pytest.mark.parametrize("hash_fun", HASHES)
def test_gl_dataset_build_2x4_both_routes_match_oracle(hash_fun):
    mesh = P.make_mesh(n_cells_shards=4, n_slot_shards=2, devices=["cpu"] * 8)
    felts = torch.stack([_felts(CFGS[min(s, N_SLOTS - 1)]) for s in range(4)])
    by_felts = P.sharded_gl_dataset_build(felts, mesh, hash_fun, BTD, n_slots=N_SLOTS)
    by_rows = P.sharded_gl_dataset_build_rows(CFGS, mesh, hash_fun, BTD)
    oracle = [_oracle_layers(hash_fun, c) for c in JCFGS]
    odset = merkle_tree([t[-1][0] for t in oracle], compress_fn(hash_fun))
    for locs, tops, dlayers in (by_felts, by_rows):
        for s in range(N_SLOTS):
            assert _slot_layers(locs, tops, s) == oracle[s]
        assert [GH.digests(lyr) for lyr in dlayers] == odset.layers
    for a, b in zip(by_felts[0][0][:N_SLOTS], by_rows[0][0][:N_SLOTS]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hash_fun", HASHES)
def test_gl_dataset_build_1x8_matches_oracle(hash_fun):
    mesh = P.make_mesh(n_cells_shards=8, devices=["cpu"] * 8)
    felts = torch.stack([_felts(c) for c in CFGS])
    locs, tops, dlayers = P.sharded_gl_dataset_build(felts, mesh, hash_fun, BTD)
    roots = [calc_slot_tree_gl(hash_fun, c).root for c in JCFGS]
    assert [GH.digests(tops[-1][s])[0] for s in range(N_SLOTS)] == roots
    assert GH.digests(dlayers[-1])[0] == merkle_tree(roots, compress_fn(hash_fun)).root


@pytest.mark.parametrize("n_shards", [1, 2])
def test_gl_single_block_slots_get_the_oracles_root(n_shards):
    # 16-byte cells, 64-byte blocks, 4 cells a slot: one block, whose root
    # still gets the bottom-odd compression in the oracle's slot tree
    cfgs = [SlotConfig(cell_size=16, block_size=64, n_cells=4, n_samples=1,
                       data_src=DataSource("fake", seed=21 + k)) for k in range(2)]
    jcfgs = [JS.SlotConfig(cell_size=16, block_size=64, n_cells=4, n_samples=1,
                           data_src=JS.DataSource("fake", seed=21 + k)) for k in range(2)]
    mesh = P.make_mesh(n_cells_shards=n_shards, devices=["cpu"] * n_shards)
    trees = [calc_slot_tree_gl("monolith", c) for c in jcfgs]
    roots = [t.root for t in trees]
    felts = torch.stack([_felts(c) for c in cfgs])
    for locs, tops, dlayers in (P.sharded_gl_dataset_build(felts, mesh, "monolith", 2),
                                P.sharded_gl_dataset_build_rows(cfgs, mesh, "monolith", 2)):
        for s, t in enumerate(trees):
            assert GH.digests(tops[-2][s]) == [t.big_tree.layers[0][0]]
            assert GH.digests(tops[-1][s]) == [roots[s]]
        assert [GH.digests(lyr) for lyr in dlayers] == merkle_tree(roots, compress_fn("monolith")).layers
