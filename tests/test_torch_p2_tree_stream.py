"""The streaming BN254 build (models/streaming.py) on the CPU against the
JAX package's oracle, bit-exact: a slot of four chunks whose layers stop at
a frontier width, the joined frontier then built to the root in one call
of K1's subtree entry (the narrow levels shared by all the chunks), and,
with a checkpoint, chunks to their roots: a whole build, and one stopped
after two chunks and resumed."""

import pytest

from codex_storage_proofs_circuits_tpu.oracle import slot as JS
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig

# 64 cells of 16 bytes, 2-cell blocks; chunks of 16 cells cut at 4 nodes
CFG = SlotConfig(cell_size=16, block_size=32, n_cells=64, n_samples=1,
                 data_src=DataSource("fake", seed=66))
JCFG = JS.SlotConfig(cell_size=16, block_size=32, n_cells=64, n_samples=1,
                     data_src=JS.DataSource("fake", seed=66))


@pytest.fixture(scope="module")
def oracle_layers():
    t = JS.calc_slot_tree(JCFG)
    return [[v for m in t.mini_trees for v in m.layers[0]]] + [list(x) for x in t.big_tree.layers]


def _ints(layers):
    return [TL.unpack(x) for x in layers]


@pytest.mark.parametrize("stop", [2, 4])
def test_streaming_chunks_share_their_narrow_levels(oracle_layers, monkeypatch, stop):
    # four chunks of 16 cells cut at `stop` nodes: the joined frontier of
    # 4 * stop nodes goes to the root in one call, with the keys of the
    # global depths
    fronts = []
    tops = TS.bn254_tops
    monkeypatch.setattr(TS, "bn254_tops", lambda roots, btd, depth: (
        fronts.append((roots.shape[1], depth)) or tops(roots, btd, depth)))
    monkeypatch.setattr(TS, "CHUNK_STOP_WIDTH", stop)
    stats = TS.StreamingStats()
    layers = TS.streaming_slot_layers(CFG, 16, stats, device="cpu")
    assert _ints(layers) == oracle_layers
    assert stats.chunks == 4 and fronts == [(4 * stop, (16 // stop).bit_length() - 1)]


def test_checkpointed_and_resumed_builds_match_oracle(oracle_layers, tmp_path, monkeypatch):
    # with a checkpoint, chunks go to their roots, in the JAX package's format
    monkeypatch.setattr(TS, "CHUNK_STOP_WIDTH", 4)
    full = TS.streaming_slot_layers(CFG, 16, device="cpu", checkpoint_dir=str(tmp_path / "a"))
    assert _ints(full) == oracle_layers
    ck = str(tmp_path / "b")
    assert TS.streaming_slot_layers(CFG, 16, device="cpu", checkpoint_dir=ck,
                                    stop_after_chunks=2) is None
    stats = TS.StreamingStats()
    resumed = TS.streaming_slot_layers(CFG, 16, stats, device="cpu", checkpoint_dir=ck)
    assert _ints(resumed) == oracle_layers
    assert (stats.chunks, stats.loaded) == (4, 2)
