"""Chunk-checkpoint resume of the port's BN254 streaming build
(models/streaming.py), and its on-disk format against the JAX package's
ChunkCheckpoint (numpy only: no JAX computation runs here).

A resumed build gives bitwise the layers of an uninterrupted one; a
checkpoint of another slot starts clean; a checkpoint written by either
package resumes in the other.
"""

import json
import os

import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models.streaming import ChunkCheckpoint as JaxCheckpoint
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource as JDataSource
from codex_storage_proofs_circuits_tpu.oracle.slot import SlotConfig as JSlotConfig
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource, SlotConfig, calc_slot_tree
from codex_storage_proofs_circuits_tpu_torch.ops import limbs as TL

# 16 cells of 16 bytes (one sponge block), 2 cells a block, chunks of 4
CFG = SlotConfig(cell_size=16, block_size=32, n_cells=16, n_samples=1,
                 data_src=DataSource("fake", seed=77))
JCFG = JSlotConfig(cell_size=16, block_size=32, n_cells=16, n_samples=1,
                   data_src=JDataSource("fake", seed=77))
CHUNK = 4


@pytest.fixture(scope="module")
def full():
    """The uninterrupted build's layers."""
    layers = TS.streaming_slot_layers(CFG, CHUNK, device="cpu")
    assert TL.unpack(layers[-1]) == [calc_slot_tree(CFG).root]
    return layers


@pytest.fixture(scope="module")
def stopped(tmp_path_factory):
    """A checkpoint directory holding chunks 0 and 1 of the port's build,
    which stopped there."""
    ck = str(tmp_path_factory.mktemp("ckpt") / "stopped")
    assert TS.streaming_slot_layers(CFG, CHUNK, device="cpu", checkpoint_dir=ck,
                                    stop_after_chunks=2) is None
    return ck


def _chunk(layers, c):
    """Chunk c's own layers (the segments of a CHUNK-cell subtree)."""
    depth = CHUNK.bit_length() - 1
    return [lyr[:, c * (CHUNK >> d) : (c + 1) * (CHUNK >> d)] for d, lyr in enumerate(layers[: depth + 1])]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_stop_then_resume_is_bitwise_the_uninterrupted_build(tmp_path, full):
    ck = str(tmp_path / "ck")
    assert TS.streaming_slot_root(CFG, CHUNK, device="cpu", checkpoint_dir=ck,
                                  stop_after_chunks=2) is None
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["chunks"] == [0, 1]
    stats = TS.StreamingStats()
    layers = TS.streaming_slot_layers(CFG, CHUNK, stats, device="cpu", checkpoint_dir=ck)
    assert (stats.chunks, stats.loaded) == (4, 2)
    assert _equal(layers, full)
    # a finished checkpoint resumes without computing a chunk
    stats = TS.StreamingStats()
    assert _equal(TS.streaming_slot_layers(CFG, CHUNK, stats, device="cpu", checkpoint_dir=ck), full)
    assert stats.loaded == 4 and stats.datagen_s == 0


def test_another_slot_or_chunk_size_starts_clean(stopped):
    assert TS.ChunkCheckpoint(stopped, CFG, CHUNK).done == {0, 1}
    other_seed = SlotConfig(cell_size=16, block_size=32, n_cells=16, n_samples=1,
                            data_src=DataSource("fake", seed=78))
    assert TS.ChunkCheckpoint(stopped, other_seed, CHUNK).done == set()
    assert TS.ChunkCheckpoint(stopped, CFG, 2 * CHUNK).done == set()


def test_jax_checkpoint_resumes_in_the_port(tmp_path, full):
    ck = str(tmp_path / "from_jax")
    jck = JaxCheckpoint(ck, JCFG, CHUNK)
    assert jck.fp == TS.ChunkCheckpoint(ck, CFG, CHUNK).fp
    for c in (0, 2):
        jck.save(c, convert.layers_to_numpy(_chunk(full, c)))
    stats = TS.StreamingStats()
    layers = TS.streaming_slot_layers(CFG, CHUNK, stats, device="cpu", checkpoint_dir=ck)
    assert (stats.chunks, stats.loaded) == (4, 2)
    assert _equal(layers, full)


def test_port_checkpoint_loads_in_jax(stopped, full):
    jck = JaxCheckpoint(stopped, JCFG, CHUNK)
    assert jck.done == {0, 1}
    for c in (0, 1):
        got = [np.asarray(x) for x in jck.load(c)]
        want = convert.layers_to_numpy(_chunk(full, c))
        assert [g.dtype for g in got] == [np.dtype(np.uint32)] * len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
