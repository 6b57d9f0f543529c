"""tools_torch/profile_stages.py's Goldilocks stages (Monolith) on the CPU
(the plain versions), against the production chunks and the JAX package's
oracle.

A slot of 64 cells of 2048 bytes (64 KB blocks) in two chunks of 32, so
that the slot's frontier has two chunk roots: each chunk's prng -> sponge
-> reduce gives that chunk's production layers (fused), the frontier of
either joined pair gives the same root, and that root is the wall stage's
(streaming_slot_root_gl) and the oracle's.  The BN254 stages:
test_torch_profile_stages.py.  About 15 s alone here.
"""

import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig
from tools_torch import profile_stages as PS

N_CELLS, CHUNK, HASH = 64, 32, "monolith"


@pytest.fixture(scope="module")
def stages():
    st = PS.Stages(True, HASH, CHUNK, N_CELLS, "cpu")
    staged = [st.reduce(st.sponge(st.prng(c))) for c in range(st.n_chunks)]
    fused = [st.fused(c) for c in range(st.n_chunks)]
    depth = len(staged[0]) - 1
    return {
        "st": st, "staged": staged, "fused": fused, "depth": depth,
        "staged_top": st.frontier(torch.cat([s[-1] for s in staged], dim=-1), depth),
        "fused_top": st.frontier(torch.cat([f[-1] for f in fused], dim=-1), depth),
        "wall": st.wall(),
    }


def test_staged_chunks_equal_the_fused_chunks(stages):
    assert stages["st"].n_chunks == 2 and stages["depth"] == 5
    for staged, fused in zip(stages["staged"], stages["fused"]):
        assert len(staged) == len(fused) == 6 and staged[-1].shape == (4, 4, 1)
        assert all(torch.equal(a, b) for a, b in zip(staged, fused))


def test_frontier_root_is_the_walls_and_the_oracles(stages):
    st = stages["st"]
    staged_top, fused_top = stages["staged_top"], stages["fused_top"]
    assert len(staged_top) == 1 and staged_top[-1].shape == (4, 4, 1)
    assert torch.equal(staged_top[-1], fused_top[-1])
    cfg = SlotConfig(cell_size=PS.CELL, block_size=PS.BLOCK, n_cells=N_CELLS, n_samples=1,
                     data_src=DataSource("fake", seed=PS.SEED))
    want = calc_slot_tree_gl(HASH, cfg).root
    assert st.root(staged_top[-1]) == stages["wall"] == want


def test_a_single_chunk_has_no_frontier():
    st = PS.Stages(True, HASH, N_CELLS, N_CELLS, "cpu")
    root = torch.zeros((4, 4, 1), dtype=torch.int32)
    assert st.frontier(root, 6) == []
