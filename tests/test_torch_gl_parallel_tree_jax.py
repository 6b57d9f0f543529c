"""One sharded Goldilocks dataset build of the port (parallel/gl_tree.py,
a 2 x 4 CPU mesh, an odd slot count) against the JAX package's
sharded_gl_dataset_build on its eight virtual devices, layer for layer:
Monolith, whose jnp permutation compiles in seconds on this CPU (the BN254
and Poseidon2-GL sharded builds compile for about a minute or more; the
other test files hold those to the oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codex_storage_proofs_circuits_tpu.parallel import make_mesh as jax_make_mesh
from codex_storage_proofs_circuits_tpu.parallel.gl_tree import (
    sharded_gl_dataset_build as jax_sharded_gl_dataset_build,
)
from codex_storage_proofs_circuits_tpu_torch import convert
from codex_storage_proofs_circuits_tpu_torch import parallel as P
from codex_storage_proofs_circuits_tpu_torch.models import data as D
from codex_storage_proofs_circuits_tpu_torch.models import gl_hashing as GH
from codex_storage_proofs_circuits_tpu_torch.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu_torch.oracle.slot import DataSource

GLOB = GlobalConfig(max_depth=8, max_log2_n_slots=5, cell_size=16, block_size=32)
DSET = DataSetConfig(n_slots=3, n_cells=8, n_samples=4, data_src=DataSource("fake", seed=12345))


def test_sharded_gl_dataset_build_equals_jax_on_eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfgs = [slot_cfg_from_dataset_cfg(GLOB, DSET, i) for i in range(DSET.n_slots)]
    felts = torch.stack([GH.encode_cells_gl(D.load_slot_cells(cfgs[min(s, 2)])) for s in range(4)])
    locs, tops, dlayers = P.sharded_gl_dataset_build(
        felts, P.make_mesh(n_cells_shards=4, n_slot_shards=2, devices=["cpu"] * 8),
        "monolith", GLOB.block_tree_depth, n_slots=DSET.n_slots)
    j_locs, j_tops, j_dlayers = jax_sharded_gl_dataset_build(
        jnp.asarray(felts.numpy().astype(np.uint32)), jax_make_mesh(n_cells_shards=4, n_slot_shards=2),
        "monolith", GLOB.block_tree_depth, n_slots=DSET.n_slots)
    for s in range(DSET.n_slots):
        for d, lyr in enumerate(locs):
            assert np.array_equal(convert.layers_to_numpy([P.join(lyr[s])])[0],
                                  np.asarray(j_locs[d][s]))
        for d, lyr in enumerate(tops):
            assert np.array_equal(convert.layers_to_numpy([lyr[s]])[0], np.asarray(j_tops[d][s]))
    assert len(dlayers) == len(j_dlayers)
    for got, want in zip(convert.layers_to_numpy(dlayers), j_dlayers):
        assert np.array_equal(got, np.asarray(want))
