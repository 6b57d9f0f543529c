"""tools_torch/profile_stages.py's BN254 production stages on the CPU (the
plain versions), each called once, against the JAX package's oracle: the
fused chunk (models/streaming._chunk_layers) and its frontier, and the
wall stage (a whole streaming_slot_root).

The slot and the cut of test_torch_profile_stages.py (64 cells of 2048
bytes in one chunk, CHUNK_STOP_WIDTH set to 4), which holds the staged path
prng -> sponge -> reduce -> frontier to the same oracle layers: the fused
chunk plus its frontier and the staged path give the same layers and the
same root, the wall's.  About 18 s alone here.
"""

import pytest

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
def fused():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "CHUNK_STOP_WIDTH", 4)
        st = PS.Stages(False, "poseidon2", N_CELLS, N_CELLS, "cpu")
        chunk = st.fused()
        top = st.frontier(chunk[-1], len(chunk) - 1)
        wall = st.wall()
    return {"st": st, "chunk": chunk, "top": top, "wall": wall}


def test_fused_chunk_and_frontier_are_the_oracles_layers(fused):
    chunk, top = fused["chunk"], fused["top"]
    assert len(chunk) == 5 and len(top) == 2
    assert [TL.unpack(lyr) for lyr in chunk + top] == oracle_layers()


def test_fused_root_is_the_walls_and_the_oracles(fused):
    assert fused["st"].root(fused["top"][-1]) == fused["wall"] == JS.calc_slot_tree(CFG).root
