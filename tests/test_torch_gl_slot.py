"""The port's Goldilocks slot trees and streaming builds (models/gl_hashing.py,
models/streaming.py) against the JAX package and the oracle, for both
hashes.

All comparisons are bit-exact.  The JAX slot tree (jitted, its permutations
unrolled into one XLA:CPU program) compiles for tens of seconds per hash on
a CPU, so it runs once per hash, on 64 cells of 64 bytes (block-tree
depth 2) reduced to 8 groups: layers 0..3, which hold the cell digests and
the key-1 compressions at depth 0 and at the block-tree depth.  Every layer
of the full tree is held against the oracle.
"""

import _torch_threads  # noqa: F401  (one torch thread a test process)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.models import data as JD
from codex_storage_proofs_circuits_tpu.models import gl_hashing as JGH
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import calc_slot_tree_gl
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as TGH
from codex_storage_proofs_circuits_tpu_torch.models import hashing as TH
from codex_storage_proofs_circuits_tpu_torch.models import streaming as TS

HASHES = ("poseidon2", "monolith")
BTD = 2  # 64-byte cells, 256-byte blocks
SLOT64 = SlotConfig(cell_size=64, block_size=256, n_cells=64, n_samples=1,
                    data_src=DataSource("fake", seed=21))
JAX_GROUPS = 8


def _oracle_layers(hash_fun: str, cfg: SlotConfig) -> list[list[tuple]]:
    """The flat cell -> block -> slot layer stack of the oracle's trees."""
    t = calc_slot_tree_gl(hash_fun, cfg)
    btd = cfg.cells_per_block.bit_length() - 1
    low = [[v for m in t.mini_trees for v in m.layers[d]] for d in range(btd)]
    return low + [list(lyr) for lyr in t.big_tree.layers]


@functools.lru_cache(maxsize=None)
def _jax_layers(hash_fun: str) -> tuple:
    felts = JGH.encode_cells_gl(JD.load_slot_cells(SLOT64))
    layers = JGH.slot_tree_from_felts_gl(hash_fun, felts, BTD, n_groups=JAX_GROUPS)
    return tuple(np.asarray(x) for x in layers)


@pytest.mark.parametrize("hash_fun", HASHES)
def test_slot_tree_layers_match_jax_and_every_layer_the_oracle(hash_fun):
    felts = TGH.encode_cells_gl(JD.load_slot_cells(SLOT64))
    jax_layers = _jax_layers(hash_fun)
    grouped = TGH.slot_tree_from_felts_gl(hash_fun, felts, BTD, n_groups=JAX_GROUPS)
    assert len(grouped) == len(jax_layers) == 4
    for got, want in zip(convert.layers_to_numpy(grouped), jax_layers):
        assert np.array_equal(got, want)
    layers = TGH.slot_tree_from_felts_gl(hash_fun, felts, BTD)
    assert len(layers) == 7
    assert all(torch.equal(a, b) for a, b in zip(layers, grouped))
    assert [TGH.digests(lyr) for lyr in layers] == _oracle_layers(hash_fun, SLOT64)


@pytest.mark.parametrize("hash_fun", HASHES)
def test_streaming_layers_match_jax_and_oracle(hash_fun):
    stats = TS.StreamingStats()
    layers = TS.streaming_slot_layers_gl(SLOT64, hash_fun, chunk_cells=16, stats=stats,
                                         device="cpu")
    assert stats.chunks == 4 and stats.cells == 64
    for got, want in zip(convert.layers_to_numpy(layers[:4]), _jax_layers(hash_fun)):
        assert np.array_equal(got, want)
    assert [TGH.digests(lyr) for lyr in layers] == _oracle_layers(hash_fun, SLOT64)


def test_extract_paths_device_on_jax_layers():
    jax_layers = list(_jax_layers("monolith"))
    idxs = [0, 5, 17, 63]
    want = np.asarray(
        JGH.extract_gl_paths_device([jnp.asarray(x) for x in jax_layers], jnp.asarray(idxs), 12)
    )
    got = TH.extract_paths_device(convert.layers_from_numpy(jax_layers),
                                  torch.tensor(idxs), 12)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
