"""tools_torch/profile_stages.py's BN254 stages on the CPU (the plain
versions), each called once, against the JAX package's oracle: the staged
path prng -> sponge -> reduce -> frontier.

A slot of 64 cells of 2048 bytes (64 KB blocks: two blocks) in one chunk,
with models/streaming.CHUNK_STOP_WIDTH set to 4 so that the chunk is cut
at 4 nodes, as a 2^18-cell chunk is cut at 2^14 on the card, and the
frontier stage has levels to build.  Every layer, the chunk's and the
frontier's, equals the oracle's layer at its depth.  The production chunk
(fused) and the wall stage are held to the same oracle layers in
test_torch_profile_stages_fused.py, so both paths give the same layers and
root; the Goldilocks stages are in test_torch_profile_stages_gl.py.  About
12 s alone here.
"""

import pytest
import torch

from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu_torch.models import streaming as S
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from tools_torch import profile_stages as PS

N_CELLS = 64
CFG = JS.SlotConfig(cell_size=PS.CELL, block_size=PS.BLOCK, n_cells=N_CELLS, n_samples=1,
                    data_src=JS.DataSource("fake", seed=PS.SEED))


def oracle_layers() -> list[list[int]]:
    """The flat cell -> block -> slot layer stack of the oracle's trees."""
    t = JS.calc_slot_tree(CFG)
    btd = CFG.cells_per_block.bit_length() - 1
    low = [[v for m in t.mini_trees for v in m.layers[d]] for d in range(btd)]
    return low + [list(lyr) for lyr in t.big_tree.layers]


@pytest.fixture(scope="module")
def staged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "CHUNK_STOP_WIDTH", 4)
        st = PS.Stages(False, "poseidon2", N_CELLS, N_CELLS, "cpu")
        rows = st.prng()
        chunk = st.reduce(st.sponge(rows))
        top = st.frontier(chunk[-1], len(chunk) - 1)
    return {"st": st, "rows": rows, "chunk": chunk, "top": top}


def test_prng_rows_are_the_oracles_cells(staged):
    rows = staged["rows"]
    assert rows.shape == (PS.CELL, N_CELLS) and rows.dtype == torch.uint8
    for i in (0, 33, 63):
        assert bytes(rows[:, i].tolist()) == JS.gen_fake_cell(PS.CELL, PS.SEED, i)


def test_staged_chunk_and_frontier_are_the_oracles_layers(staged):
    chunk, top = staged["chunk"], staged["top"]
    assert len(chunk) == 5 and chunk[-1].shape == (TL.NL, 4)  # cut at 4 nodes: 4 levels
    assert len(top) == 2
    assert [TL.unpack(lyr) for lyr in chunk + top] == oracle_layers()


def test_staged_root_is_the_oracles(staged):
    assert staged["st"].root(staged["top"][-1]) == JS.calc_slot_tree(CFG).root
